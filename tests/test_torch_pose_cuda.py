"""The pose data plane on the card against the CPU: the crop
(`warp_affine`), the resize, the blur, the labelling and the UDP decode
of `omni/pose_utils.py`, and the Sapiens backbone at 2 layers of the 1b
width (dim 1536, 24 heads, 1024x768, 308 keypoints). Every test is
marked `cuda` and skips without a GPU. This file imports no JAX:

    python -m pytest tests/test_torch_pose_cuda.py -m cuda -q --noconftest

Tolerances: the crop and the resize within 1 uint8 level of the CPU's
(the card and the CPU may round an exact .5 apart); the blur 1e-6
absolute; labels and stats exact (the mask comes from the card, the
labelling runs on the host); UDP keypoints 1e-3 heatmap-input pixels;
Sapiens heatmaps 5e-3 of their peak (cuDNN may run the fp32 patch embed
and deconvs in TF32, as PyTorch allows by default: 1e-3 of the peak
measured on an H100)."""

import copy

import numpy as np
import pytest
import torch

from omnihuman_tpu_torch.omni import pose_utils as pu
from omnihuman_tpu_torch.omni import sapiens as sap


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card-against-CPU checks")
    return torch.device("cuda")


def _frame(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (480, 832, 3), dtype=np.uint8)
    img[100:400, 150:300] = 250
    img[200:380, 500:640] = 200
    return img


@pytest.mark.cuda
@pytest.mark.parametrize("bbox", [(150.0, 100.0, 300.0, 400.0),
                                  (-40.0, -20.0, 900.0, 500.0)])
def test_crop_and_resize_on_card_match_cpu(cuda_device, bbox):
    img = _frame()
    box = np.array(bbox + (1.0,), np.float32)
    cpu, *_ = pu.top_down_affine_transform(img, box, (768, 1024))
    card, *_ = pu.top_down_affine_transform(
        torch.from_numpy(img).to(cuda_device), box, (768, 1024))
    assert card.device.type == "cuda"
    assert (card.cpu().int() - cpu.int()).abs().max().item() <= 1
    r_cpu = pu.resize_image(img, (768, 1024))
    r_card = pu.resize_image(torch.from_numpy(img).to(cuda_device),
                             (768, 1024))
    assert (r_card.cpu().int() - r_cpu.int()).abs().max().item() <= 1


@pytest.mark.cuda
def test_blur_labels_and_decode_on_card_match_cpu(cuda_device):
    rng = np.random.default_rng(1)
    hm = (rng.random((308, 256, 192)) ** 8).astype(np.float32)
    hm[:, 100:110, 80:95] += 1.0
    cpu = pu.gaussian_blur(hm)
    card = pu.gaussian_blur(torch.from_numpy(hm).to(cuda_device))
    torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=1e-6)
    resp = torch.from_numpy(hm).to(cuda_device).amax(0)
    mask_card = (resp >= 0.3).to(torch.uint8).cpu().numpy()
    mask_cpu = (hm.max(0) >= 0.3).astype(np.uint8)
    n_a, lab_a, st_a = pu.connected_components(mask_card)
    n_b, lab_b, st_b = pu.connected_components(mask_cpu)
    assert n_a == n_b and (lab_a == lab_b).all() and (st_a == st_b).all()
    kp_a, s_a = pu.udp_decode(torch.from_numpy(hm).to(cuda_device),
                              (768, 1024))
    kp_b, s_b = pu.udp_decode(hm, (768, 1024))
    np.testing.assert_allclose(kp_a, kp_b, atol=1e-3)
    np.testing.assert_array_equal(s_a, s_b)


@pytest.mark.cuda
def test_sapiens_two_layers_full_width_on_card_matches_cpu(cuda_device):
    cfg = sap.SapiensConfig(depth=2)              # the 1b width, 2 layers
    model = sap.build_sapiens(cfg, "cpu", seed=3)
    crops = np.random.default_rng(2).integers(0, 256, (2, 1024, 768, 3),
                                              dtype=np.uint8)
    want = sap.SapiensBackbone(model=copy.deepcopy(model),
                               device="cpu").batch(crops)
    got = sap.SapiensBackbone(model=model, device=cuda_device
                              ).batch(crops).cpu()
    assert got.shape == (2, 308, 256, 192)
    err = (got - want).abs().max().item()
    assert err <= 5e-3 * want.abs().max().item(), err
