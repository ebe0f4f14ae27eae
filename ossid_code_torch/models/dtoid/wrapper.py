"""Standalone DTOID inference wrapper (the port of
ossid_code_tpu/models/dtoid/wrapper.py; the role of the reference's
models/dtoid/wrapper.py, the original-author-style API): it loads a
checkpoint and a template directory and detects one object a call, with
optional z-filtering. Each call is `DtoidModel.forward_test_time` over
`n_local` templates taken by linspace, so on the card it launches kernel 1
(csrc/dw_corr3x3.cu) twice a call, through ops/conv.py's dispatch.
"""

from __future__ import annotations

import numpy as np

from ossid_code_torch.core.config import default_config
from ossid_code_torch.data.templates import TemplateDataset


class DTOIDWrapper:
    def __init__(self, ckpt_path: str | None, template_root: str, obj_ids, n_local: int = 10,
                 use_provided_template: bool = False, cfg=None, filter_z: bool = False, device=None):
        """`device`: None runs on the card; "cpu" the plain path."""
        cfg = cfg or default_config()
        cfg.model.filter_z = filter_z
        from ossid_code_torch.core.checkpoint import load_checkpoint
        from ossid_code_torch.models.dtoid.module import DtoidModel

        self.model = DtoidModel(cfg, device=device)
        if ckpt_path:
            self.model.load_state_dict(load_checkpoint(ckpt_path))
        self.templates = TemplateDataset(template_root, obj_ids, use_provided_template=use_provided_template)
        self.n_local = n_local

    def getTemplates(self, obj_id):
        limg, lxyz, lmask = self.templates.getTemplatesAll(obj_id)
        if len(limg) > self.n_local:
            sel = np.linspace(0, len(limg) - 1, self.n_local).round().astype(int)
            limg, lxyz, lmask = limg[sel], lxyz[sel], lmask[sel]
        return limg, lxyz, lmask

    def forward(self, img, obj_id, mask=None):
        """img (H, W, 3) uint8 or float [0, 1] -> the detection dict (the
        reference's output schema)."""
        limg, _, lmask = self.getTemplates(obj_id)
        batch = {"img": img, "obj_id": obj_id, "limg": limg, "lmask": lmask, "mask": mask}
        if self.templates.use_provided_template:
            batch["template_z_values"] = self.templates.template_z_values
        return self.model.forward_test_time(batch)

    __call__ = forward
