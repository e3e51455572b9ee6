"""The span recorder (`utils/spans.py`) and the spans the port opens.

On the CPU: nothing is recorded without a profiler, and the stage times
are filled as before; inside a CPU `torch.profiler` session spans nest by
parent and root ids on the profiler's own clock; a DiT forward gives each
block its spans; a one-step request and a distill step give theirs;
`torch.export` under a profiler traces no span. On the card (marked
`cuda`): a kernel launched inside a span lies within the span's device
interval on the profiler's clock.
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from omnihuman_tpu_torch.configs import TINY_TEST
from omnihuman_tpu_torch.configs.wan import DTypePolicy
from omnihuman_tpu_torch.models.wan_dit import build_wan_model
from omnihuman_tpu_torch.ops.rope import rope_angles_3d
from omnihuman_tpu_torch.utils import spans

F32 = DTypePolicy(compute=torch.float32)


@pytest.fixture(autouse=True)
def fresh():
    spans.clear()
    yield
    spans.clear()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def tiny_step_inputs(device="cpu"):
    """The tiny DiT and one forward's arguments (2 clips, 2 x 4 x 4
    tokens, text of 5 and 16 valid rows)."""
    m = TINY_TEST.model
    model = build_wan_model(m, device, torch.float32, seed=0)
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((2, m.out_dim, 2, 8, 8), generator=gen, device=device)
    t = torch.tensor([999.0, 500.0], device=device)
    ctx = torch.randn((2, m.text_len, m.text_dim), generator=gen,
                      device=device)
    lens = torch.tensor([5, m.text_len], dtype=torch.int32, device=device)
    sin, cos = rope_angles_3d((2, 4, 4), m.head_dim, seq_len=32,
                              device=device)
    kw = dict(seq_len=32, rope_sin=sin, rope_cos=cos, context_lens=lens,
              policy=F32)
    return model, (x, t, ctx), kw


def by_name(recorded):
    out = {}
    for s in recorded:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_records_nothing_and_stages_keep_their_times():
    model, args, kw = tiny_step_inputs()
    timings = {}
    with torch.no_grad(), spans.stage("dit_s", timings, "cpu") as st:
        model(*args, **kw)
    assert spans.span("block") is spans.span("request", seed=1)
    assert spans.collected() == []
    assert set(timings) == {"dit_s"} and timings["dit_s"] == st.seconds > 0
    with spans.stage("window_s", None, None) as st:
        pass
    assert st.seconds >= 0


def test_spans_nest_by_thread_on_the_profiler_clock():
    """Parent and root ids from a stack per thread (another thread starts
    roots of its own); a record_function opened inside a span lies within
    the span's host interval, on kineto's clock."""
    def worker():
        with spans.span("other", index=7):
            pass

    with cpu_profile() as prof:
        with spans.span("request", seed=3) as req:
            with spans.span("a") as a:
                with record_function("mark"):
                    sum(range(10000))
            th = threading.Thread(target=worker)
            th.start()
            th.join()
            with spans.span("b"):
                with spans.span("c"):
                    pass
    got = by_name(spans.collected())
    assert [s["name"] for s in spans.collected()] == ["request", "a",
                                                      "other", "b", "c"]
    assert got["request"][0]["parent"] is None
    assert got["request"][0]["attrs"] == {"seed": 3}
    assert got["a"][0]["parent"] == got["b"][0]["parent"] == req.id
    assert got["c"][0]["parent"] == got["b"][0]["id"]
    assert {got[n][0]["root"] for n in "abc"} == {req.id}
    other = got["other"][0]
    assert other["parent"] is None and other["root"] == other["id"]
    assert other["thread"] != got["a"][0]["thread"]
    assert all(s["device"] is None for s in spans.collected())
    mark = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "mark"][0]
    t0, t1 = got["a"][0]["host"]
    assert a.id == got["a"][0]["id"]
    assert t0 <= mark.start_ns() <= mark.start_ns() + mark.duration_ns() <= t1


def test_dit_forward_opens_the_block_spans():
    model, args, kw = tiny_step_inputs()
    with cpu_profile(), torch.no_grad():
        model(*args, **kw)
    got = by_name(spans.collected())
    n = TINY_TEST.model.num_layers
    assert {k: len(v) for k, v in got.items()} == {
        "block": n, "self_attn": n, "cross_attn": n, "ffn": n}
    assert [b["attrs"]["layer"] for b in got["block"]] == list(range(n))
    ids = [b["id"] for b in got["block"]]
    for part in ("self_attn", "cross_attn", "ffn"):
        assert [s["parent"] for s in got[part]] == ids
    for b in got["block"]:
        assert b["parent"] is None and b["root"] == b["id"]


def test_request_and_train_step_spans():
    """A one-step request: the root `request` over text_encode (tokenize,
    t5, trim), prep, dit and vae_decode, one root id; frames_per_sec over
    the request's wall time. A distill step: train_step over forward,
    backward (with the blocks' recompute) and optimizer."""
    from omnihuman_tpu_torch.apt.distill import (
        distill_train_step, init_distill_state, make_optimizer)
    from omnihuman_tpu_torch.pipelines.text2video import WanT2V
    from omnihuman_tpu_torch.pipelines.wan_inference import (
        SeaweedWanAPTGenerator)

    class Tokenizer:
        def __call__(self, prompts, return_mask=False):
            ids = np.ones((len(prompts), TINY_TEST.text_len), np.int64)
            mask = np.zeros_like(ids)
            mask[:, :4] = 1
            return ids * mask, mask

    pipe = WanT2V(TINY_TEST, param_dtype=torch.float32, device="cpu",
                  tokenizer=Tokenizer())
    gen = SeaweedWanAPTGenerator(pipe)
    with cpu_profile():
        video = gen.generate_batch(["a", "b"], size=(32, 32), frame_num=5,
                                   seed=4)
    got = spans.collected()
    names = by_name(got)
    req = names["request"][0]
    assert req["attrs"] == {"seed": 4, "batch": 2}
    assert all(s["root"] == req["id"] for s in got)
    top = [s["name"] for s in got if s["parent"] == req["id"]]
    assert top == ["text_encode", "prep", "dit", "vae_decode"]
    enc = names["text_encode"][0]["id"]
    assert [s["name"] for s in got if s["parent"] == enc] == [
        "tokenize", "t5", "trim"]
    assert len(names["block"]) == TINY_TEST.model.num_layers
    wall = (req["host"][1] - req["host"][0]) * 1e-9
    frames = video.shape[0] * video.shape[2]
    assert set(gen.timings) == {"text_encode_s", "dit_s", "vae_decode_s",
                                "frames_per_sec"}
    assert frames / gen.timings["frames_per_sec"] == pytest.approx(
        wall, rel=0.05, abs=2e-3)

    spans.clear()
    model, (x, _, ctx), kw = tiny_step_inputs()
    model.train().requires_grad_(True)
    opt = make_optimizer()
    state = init_distill_state(model, opt)
    batch = {"noise": x[:1], "context": ctx[:1], "v_teacher": x[1:]}
    with cpu_profile():
        distill_train_step(state, batch, optimizer=opt, seq_len=32,
                           rope_sin=kw["rope_sin"], rope_cos=kw["rope_cos"],
                           policy=F32, remat=True)
    got = spans.collected()
    names = by_name(got)
    root = names["train_step"][0]
    assert root["attrs"]["step"] == 0
    assert [s["name"] for s in got if s["parent"] == root["id"]] == [
        "forward", "backward", "optimizer"]
    # the forward's blocks, then their recompute inside the backward
    assert len(names["block"]) == 2 * TINY_TEST.model.num_layers


def test_export_under_a_profiler_traces_no_span():
    model, args, kw = tiny_step_inputs()

    class Step(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, x, t, ctx):
            return self.model(x, t, ctx, **kw)

    with torch.no_grad():
        want = Step()(*args)
        with cpu_profile():
            ep = torch.export.export(Step(), args, strict=False)
        assert spans.collected() == []
        targets = " ".join(str(n.target) for n in ep.graph.nodes)
        assert "profiler" not in targets and "record" not in targets
        torch.testing.assert_close(ep.module()(*args), want)


@pytest.mark.cuda
def test_a_kernel_lies_within_its_span_on_the_card():
    """A matmul launched inside a span, after other work queued on the
    card: its kernel, on kineto's clock, lies within the span's device
    interval to 20 us, and the device interval starts after the host
    start."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: device times come from CUDA "
                    "events")
    a = torch.randn(4096, 4096, device="cuda")
    (a @ a).sum().item()
    slack = 20_000
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with spans.span("first"):          # the session's anchor
            pass
        for _ in range(4):
            a @ a                          # queued work before the span
        with spans.span("mm") as s:
            b = a.t().contiguous()
            c = b @ b
        torch.cuda.synchronize()
    assert c.shape == (4096, 4096)
    rec = {x["id"]: x for x in spans.collected()}[s.id]
    d0, d1 = rec["device"]
    assert d0 >= rec["host"][0] - slack, (d0, rec["host"])
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA
                     and e.duration_ns() > 0)
    inside = [k for k in kernels if k[0] >= d0 - slack]
    before = [k for k in kernels if k[0] < d0 - slack]
    where = f"span {d0}-{d1}, host {rec['host']}, kernels {kernels}"
    assert len(inside) >= 2 and len(before) >= 4, where
    assert abs(inside[-1][1] - d1) <= slack, where    # the GEMM ends it
    assert all(k1 <= d1 + slack for _, k1 in inside), where
    assert all(k1 <= d0 + slack for _, k1 in before), where
    assert before[-1][1] >= d0 - slack, where   # the queue ran up to it
