"""The port's prompt expansion (utils/prompt_extend.py) and Qwen-VL vision
helpers (utils/qwen_vl_utils.py) against the JAX package.

- `TemplatePromptExpander` returns JAX's string for the same seed (en and
  zh, through `extend`): exact;
- `DashScopePromptExpander` refuses without a key and without the
  `dashscope` package, as JAX does; nothing reaches the network;
- `QwenPromptExpander` on the CPU with a stub chat tokenizer takes the
  port's Qwen route ("qwen-torch") and returns the decoded greedy tokens;
  an eos id of 0 is passed on as an eos id; without weights it falls back
  to the template with JAX's message prefix;
- `smart_resize`, `smart_nframes`, `fetch_image` and `process_vision_info`
  equal JAX's exactly; a video file's frames after the torch resize are
  within 2 levels of JAX's cv2.resize (cv2 weighs in 11-bit fixed point).
"""

import base64
import io
import json
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from omnihuman_tpu.utils import prompt_extend as jpe
from omnihuman_tpu.utils import qwen_vl_utils as jvl
from omnihuman_tpu_torch.models import qwen as pq
from omnihuman_tpu_torch.utils import prompt_extend as ppe
from omnihuman_tpu_torch.utils import qwen_vl_utils as pvl

torch.set_num_threads(1)


@pytest.mark.parametrize("lang", ["en", "zh"])
@pytest.mark.parametrize("seed", [0, 11, 2 ** 31 - 5])
def test_template_expander_equals_jax(lang, seed):
    prompt = "a corgi rides a skateboard." if lang == "en" else "一只柯基。"
    got = ppe.TemplatePromptExpander()(prompt, seed=seed, tar_lang=lang)
    want = jpe.TemplatePromptExpander()(prompt, seed=seed, tar_lang=lang)
    assert got.status and got.prompt == want.prompt
    assert (got.seed, got.system_prompt, got.message) == (
        want.seed, want.system_prompt, want.message)


def test_system_prompts_are_the_jax_strings():
    for name in ("LM_EN_SYS_PROMPT", "LM_ZH_SYS_PROMPT", "VL_EN_SYS_PROMPT"):
        assert getattr(ppe, name) == getattr(jpe, name)
    assert (ppe.PromptExpander(is_vl=True).decide_system_prompt("zh")
            == jpe.VL_EN_SYS_PROMPT)


def test_dashscope_refuses_without_key_or_package(monkeypatch):
    monkeypatch.delenv("DASH_API_KEY", raising=False)
    out = ppe.DashScopePromptExpander()("a fox", seed=3)
    want = jpe.DashScopePromptExpander()("a fox", seed=3)
    assert not out.status and out.message == want.message == \
        "DASH_API_KEY not set"
    assert out.prompt == "a fox"
    monkeypatch.setitem(sys.modules, "dashscope", None)   # import fails
    out = ppe.DashScopePromptExpander(api_key="k")("a fox", seed=3)
    assert not out.status and out.message == "dashscope not installed"


class StubChatTokenizer:
    """Chat template over a byte vocabulary (tests/test_qwen_expander.py)."""

    def __init__(self, eos_token_id=2):
        self.eos_token_id = eos_token_id

    def apply_chat_template(self, msgs, tokenize=False,
                            add_generation_prompt=True):
        return "\n".join(f"{m['role']}: {m['content']}" for m in msgs)

    def __call__(self, texts, return_tensors="np"):
        ids = np.asarray([[3 + (b % 120) for b in texts[0].encode()]],
                         np.int32)

        class R:
            input_ids = ids

        return R()

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(97 + int(t) % 26) for t in ids)


@pytest.fixture(scope="module")
def qwen_dir(tmp_path_factory):
    from safetensors.torch import save_file
    cfg = pq.QwenConfig(vocab_size=128, dim=64, ffn_dim=96, num_layers=2,
                        num_heads=4, num_kv_heads=2)
    model = pq.build_qwen(cfg, "cpu", seed=4)
    d = tmp_path_factory.mktemp("qwen")
    save_file({k: v.contiguous() for k, v in model.state_dict().items()},
              str(d / "model.safetensors"))
    json.dump({"num_attention_heads": 4, "rope_theta": 1e6,
               "rms_norm_eps": 1e-6}, open(d / "config.json", "w"))
    return str(d), model


@pytest.mark.parametrize("eos", [2, 0])
def test_qwen_expander_takes_the_torch_route(qwen_dir, monkeypatch, eos):
    path, model = qwen_dir
    seen = {}
    real = pq.qwen_generate

    def recording(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    monkeypatch.setattr(pq, "qwen_generate", recording)
    e = ppe.QwenPromptExpander(checkpoint_path=path, device="cpu",
                               max_new_tokens=6)
    tok = StubChatTokenizer(eos)
    e._tok = tok
    out = e("a corgi rides a skateboard", seed=11)
    assert out.status and out.message == "qwen-torch"
    assert seen["eos_id"] == eos and seen["max_new_tokens"] == 6
    ids = torch.as_tensor(e._chat_ids("a corgi rides a skateboard",
                                      ppe.LM_EN_SYS_PROMPT)).long()
    gen = real(model, ids, torch.tensor([ids.shape[1]]), 6, eos_id=eos)
    assert out.prompt == tok.decode([t for t in gen[0].tolist()
                                     if t != eos])


def test_qwen_expander_falls_back_with_the_jax_message():
    e = ppe.QwenPromptExpander(model_name="nonexistent/model", device="cpu")
    out = e("a fox", seed=2)
    want = jpe.TemplatePromptExpander()("a fox", seed=2)
    assert out.status and out.prompt == want.prompt
    assert out.message == "Qwen weights unavailable; " + want.message


def test_qwen_expander_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        assert ppe.QwenPromptExpander().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ppe.QwenPromptExpander()


def test_smart_resize_and_nframes_equal_jax():
    for h in (1, 27, 28, 100, 333, 480, 1080, 4000):
        for w in (28, 57, 640, 832, 1920, 5000):
            for mn, mx in ((pvl.MIN_PIXELS, pvl.MAX_PIXELS),
                           (pvl.VIDEO_MIN_PIXELS, pvl.VIDEO_MAX_PIXELS)):
                if max(h, w) / min(h, w) > pvl.MAX_RATIO:
                    with pytest.raises(ValueError):
                        pvl.smart_resize(h, w, 28, mn, mx)
                    continue
                assert pvl.smart_resize(h, w, 28, mn, mx) == \
                    jvl.smart_resize(h, w, 28, mn, mx)
    for ele, total, fps in (({}, 120, 30.0), ({"fps": 4.0}, 90, 24.0),
                            ({"nframes": 7}, 50, 25.0),
                            ({"min_frames": 9, "max_frames": 20}, 400, 30.0)):
        assert pvl.smart_nframes(ele, total, fps) == \
            jvl.smart_nframes(ele, total, fps)


def _png(tmp_path, seed, hw=(90, 130)):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, size=hw + (3,), dtype=np.uint8)
    path = tmp_path / f"img{seed}.png"
    Image.fromarray(arr).save(path)
    return path, arr


def test_process_vision_info_equals_jax(tmp_path):
    p1, _ = _png(tmp_path, 1)
    p2, arr2 = _png(tmp_path, 2, (60, 60))
    _, arr3 = _png(tmp_path, 3)
    buf = io.BytesIO()
    Image.fromarray(arr2).save(buf, format="PNG")
    b64 = "data:image;base64," + base64.b64encode(buf.getvalue()).decode()
    msgs = [{"role": "user", "content": [
        {"type": "image", "image": str(p1)},
        {"image": f"file://{p2}", "resized_height": 56, "resized_width": 84},
        {"image_url": b64, "min_pixels": 100 * 28 * 28},
        {"video": [str(p1), Image.fromarray(arr3)]},
        {"type": "text", "text": "describe"}]}]
    got_i, got_v = pvl.process_vision_info(msgs)
    want_i, want_v = jvl.process_vision_info(msgs)
    assert len(got_i) == len(want_i) == 3 and len(got_v) == len(want_v) == 1
    for g, w in zip(got_i, want_i):
        assert g.size == w.size
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    np.testing.assert_array_equal(got_v[0], want_v[0])
    assert pvl.process_vision_info([{"role": "user", "content": "hi"}]) == \
        (None, None)
    with pytest.raises(RuntimeError, match="network"):
        pvl.fetch_image("https://example.invalid/a.png")


def test_fetch_video_file_close_to_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.avi")
    rng = np.random.default_rng(7)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 8.0,
                             (96, 64))
    for _ in range(12):
        writer.write(rng.integers(0, 256, size=(64, 96, 3), dtype=np.uint8))
    writer.release()
    ele = {"video": path}
    got = pvl.fetch_video(ele)
    want = jvl.fetch_video(ele)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 2
