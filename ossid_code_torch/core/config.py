"""Config tree and DTOID model defaults (copy of ossid_code_tpu/core/config.py).

A `Config` is a recursive attribute dict that round-trips YAML. The defaults
mirror the reference's conf/model/dtoid.yaml and conf/dataset/dtoid_bop.yaml.
The model group also names the JAX package's two bf16 switches,
`bf16_finetune` and `bf16_infer`, at the default the JAX package reads them
with (`m.get(..., False)`; its own defaults leave them out); the port's
DtoidModel reads them the same way. The JAX package's transport knobs
(packed single-buffer fetch) are not read by the port.

`roots()` gives the path roots of the online-learning CLI, the JAX
package's environment roots with its defaults, read when it is called.
"""

from __future__ import annotations

import copy
import os


class Config(dict):
    """dict with attribute access, recursively."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.update(dict(*args, **kwargs))

    def update(self, other):
        for k, v in other.items():
            self[k] = v

    def __setitem__(self, k, v):
        if isinstance(v, dict) and not isinstance(v, Config):
            v = Config(v)
        super().__setitem__(k, v)

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()}

    def save(self, path: str):
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    @classmethod
    def load(cls, path: str) -> "Config":
        import yaml

        with open(path) as f:
            return cls(yaml.safe_load(f))

    def merged(self, other: dict) -> "Config":
        out = copy.deepcopy(self)

        def _merge(dst, src):
            for k, v in src.items():
                if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
                    _merge(dst[k], v)
                else:
                    dst[k] = v

        _merge(out, other)
        return out


def roots() -> Config:
    """The CLI's path roots from the environment, read now, with the JAX
    package's defaults (ossid_code_tpu/core/config.py:78-89): OSSID_ROOT,
    BOP_DATASETS_ROOT, OSSID_CKPT_ROOT, OSSID_DATA_ROOT, OSSID_RESULT_ROOT,
    BOP_RESULTS_FOLDER and BOP_TOOLKIT_PATH."""
    env = os.environ
    base = env.get("OSSID_ROOT", os.path.join(os.path.expanduser("~"), "ossid_workspace"))
    defaults = {"BOP_DATASETS_ROOT": "bop", "OSSID_CKPT_ROOT": "ckpts", "OSSID_DATA_ROOT": "data",
                "OSSID_RESULT_ROOT": "results", "BOP_RESULTS_FOLDER": "bop_results",
                "BOP_TOOLKIT_PATH": "bop_toolkit"}
    return Config(OSSID_ROOT=base, **{k: env.get(k, os.path.join(base, d)) for k, d in defaults.items()})


def dtoid_model_config() -> Config:
    return Config(
        name="dtoid",
        lam_seg=20.0,
        lam_center=20.0,
        lam_cls=1.0,
        lam_reg=1.0,
        learning_rate=1e-4,
        weight_decay=1e-6,
        nms_iou_thresh=0.5,
        img_h=480,
        img_w=640,
        heatmap_h=29,
        heatmap_w=39,
        template_size=124,
        filter_z=False,
        valid_all_templates=False,
        use_pretrained_dtoid=False,
        pretrained_dtoid_path=None,
        monitor="valunseen_seg_IoU",
        monitor_mode="max",
        max_epochs=100,
        save_top_k=5,
        compute_dtype="float32",
        # DenseNet block2/3/4 repeats (torchvision densenet121 = 12/24/16)
        densenet_blocks=(12, 24, 16),
        topk_pre_nms=1000,
        topk_post_nms=500,
        # seg mask transfer: 'packed' = mask thresholded at 0.5 packed
        # 8 px/byte; 'u8' keeps quantized probabilities
        seg_transfer="packed",
        # mixed-precision finetune step and bf16 detection (DtoidModel)
        bf16_finetune=False,
        bf16_infer=False,
    )


def dtoid_bop_dataset_config() -> Config:
    """The dataset group (ref conf/dataset/dtoid_bop.yaml); the roots come
    from BOP_DATASETS_ROOT / OSSID_GRID_ROOT or are set by the caller."""
    return Config(
        name="dtoid_bop",
        bop_root=os.environ.get("BOP_DATASETS_ROOT", ""),
        grid_root=os.environ.get("OSSID_GRID_ROOT", ""),
        use_provided_template=False,
        test_dataset_name="lmo",
        train_dataset_name=None,
        load_zephyr_result=False,
        zephyr_result_path=None,
        zephyr_filter_key="score",
        zephyr_filter_threshold=20,
        zephyr_results_percent=1.0,
        keep_aspect_ratio=True,
        shorter_length=480,
        heatmap_var=1.5,
        heatmap_shorter_length=29,
        ttt_sampling=False,
        train_local_template_sample_from=1,
        n_local_test=10,
        img_h=480,
        img_w=640,
        heatmap_h=29,
        heatmap_w=39,
        n_classes=15,
    )


def default_config() -> Config:
    return Config(
        dataset=dtoid_bop_dataset_config(),
        model=dtoid_model_config(),
        train=Config(batch_size=4, num_workers=0, val_shuffle=False, n_epochs=100),
        seed=42,
    )
