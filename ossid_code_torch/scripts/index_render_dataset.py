"""Build the object2files.json index of a BlenderProc render dataset (the
port's copy of ossid_code_tpu/scripts/index_render_dataset.py, ref
scripts/index_render_dataset.py:1-56): map object id -> scene files where
the object is visible with at least `min_pixels` pixels.

    python -m ossid_code_torch.scripts.index_render_dataset --dataset_root <dir> [--min_pixels 1000]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from ossid_code_torch.data.hdf5_render import load_hdf5, object_mask_from_segmap


def index_render_dataset(root: str, min_pixels: int = 1000) -> dict:
    obj2files: dict[str, list[str]] = {}
    for path in sorted(glob.glob(os.path.join(root, "*.hdf5"))):
        name = os.path.splitext(os.path.basename(path))[0]
        data = load_hdf5(path)
        for obj in data["objects"]:
            mask = object_mask_from_segmap(data["segmap"], data["segcolormap"], obj["obj_id"])
            if mask is None or mask.sum() < min_pixels:
                continue
            obj2files.setdefault(str(obj["obj_id"]), []).append(name)
    return obj2files


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_root", required=True)
    parser.add_argument("--min_pixels", type=int, default=1000)
    args = parser.parse_args(argv)
    obj2files = index_render_dataset(args.dataset_root, args.min_pixels)
    out = os.path.join(args.dataset_root, "object2files.json")
    with open(out, "w") as f:
        json.dump(obj2files, f)
    print(f"indexed {sum(len(v) for v in obj2files.values())} entries -> {out}")


if __name__ == "__main__":
    main()
