"""The port's full-width ViT-B-32-quickgelu vs the open_CLIP reference outputs.

Same fixture and discipline as tests/test_openclip_goldens.py: the weights
are regenerated from the fixture's (key, shape) manifest with
`utils/det_weights.py` (the port's copy) and converted with the port's
`bridge.params_from_openclip_state_dict`; features must match the reference
CLIP's within 2e-5 in fp32 on the CPU.
"""
import json
import os

import numpy as np
import pytest

from megatron_clip_tpu_torch import create_model
from megatron_clip_tpu_torch.bridge import params_from_openclip_state_dict
from megatron_clip_tpu_torch.utils.det_weights import (det_images,
                                                       det_state_dict,
                                                       det_texts)

FIXTURE = os.path.join(os.path.dirname(__file__), "goldens", "full",
                       "vitb32.npz")


def test_full_vitb32_quickgelu_matches_reference():
    z = np.load(FIXTURE)
    manifest = json.loads(bytes(z["manifest"]).decode())
    model = create_model("ViT-B-32-quickgelu", precision="fp32", device="cpu")
    sd = det_state_dict("vitb32", [(k, tuple(s)) for k, s in manifest])
    model.load_state_dict(params_from_openclip_state_dict(sd, model.cfg))
    images = det_images("vitb32", 4, 224)
    texts = det_texts("vitb32", 4, 77, 49408, sot=49406, eot=49407,
                      pad_tail=2)
    np.testing.assert_allclose(model.encode_image(images).numpy(),
                               z["image_features"], atol=2e-5)
    np.testing.assert_allclose(model.encode_text(texts).numpy(),
                               z["text_features"], atol=2e-5)


def test_position_table_resize_is_refused():
    model = create_model("ViT-B-32-quickgelu", precision="fp32", device="cpu",
                         vision_cfg={"image_size": 160, "layers": 1,
                                     "width": 64, "patch_size": 32})
    sd = {"visual.conv1.weight": np.zeros((64, 3, 32, 32), np.float32),
          "visual.positional_embedding": np.zeros((50, 64), np.float32)}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        params_from_openclip_state_dict(sd, model.cfg)
