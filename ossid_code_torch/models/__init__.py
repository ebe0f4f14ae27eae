"""Model registry (the port of ossid_code_tpu/models/__init__.py)."""


def get_model(cfg, seed: int = 42, device=None):
    """`cfg.model.name` 'dtoid' or 'maskrcnn', on `device` (None -> cuda),
    with `cfg.weights_path` loaded when set; another name raises ValueError."""
    if cfg.model.name == "dtoid":
        from ossid_code_torch.models.dtoid.module import DtoidModel

        model = DtoidModel(cfg, seed=seed, device=device)
    elif cfg.model.name == "maskrcnn":
        from ossid_code_torch.models.maskrcnn import MaskRCNN

        model = MaskRCNN(cfg, seed=seed, device=device)
    else:
        raise ValueError(f"Unknown cfg.model.name = {cfg.model.name}")

    if cfg.get("weights_path"):
        from ossid_code_torch.core.checkpoint import load_checkpoint

        model.load_state_dict(load_checkpoint(cfg.weights_path))
    return model
