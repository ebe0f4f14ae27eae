"""Incremental file-copy helper (ref scripts/file_copy.py:1-24; the port of
ossid_code_tpu/scripts/file_copy.py): copy files
matching a glob into a destination directory, skipping ones that already exist
with the same size."""

from __future__ import annotations

import argparse
import glob
import os
import shutil


def copy_files(src_glob: str, dst_dir: str, verbose: bool = True) -> int:
    os.makedirs(dst_dir, exist_ok=True)
    n = 0
    for src in sorted(glob.glob(src_glob)):
        dst = os.path.join(dst_dir, os.path.basename(src))
        if os.path.exists(dst) and os.path.getsize(dst) == os.path.getsize(src):
            continue
        shutil.copy2(src, dst)
        n += 1
        if verbose:
            print(f"copied {src} -> {dst}")
    return n


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", required=True, help="source glob")
    parser.add_argument("--dst", required=True, help="destination directory")
    args = parser.parse_args()
    n = copy_files(args.src, args.dst)
    print(f"{n} files copied")


if __name__ == "__main__":
    main()
