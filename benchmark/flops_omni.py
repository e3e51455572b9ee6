"""Model FLOPs and K1 bounds of OmniHuman's window step
(`pipelines/omni.py:omni_cfg_step`): one conditional forward over the
packed tokens (video, motion, reference) with the pose guider, the audio
MLP and an audio adapter in every block, then one unconditional forward
over the video tokens with the negative prompt alone. Counted as
`benchmark/flops.py` counts the Wan DiT (2 x the multiply-adds of every
matmul and convolution for the valid tokens, attention at 4 x head_dim
per query, valid key and head), whose functions this file uses."""

from __future__ import annotations

from typing import Sequence

from benchmark import flops


def pose_guider_flops(o: dict, m: dict, frames: int, h2: int,
                      w2: int) -> float:
    """The guider's three causal 3x3x3 convs on heatmaps [K, frames, h2,
    w2] (2 x 27 x Cin x Cout per output position; strides 1, 2, 2 on h /
    w) and `pose_proj` on every cell tiled over its patch. `o`: the omni
    sizes (OmniModelConfig fields but `base`)."""
    h1, hid2 = o["pose_hidden"]
    c4 = m["dim"] // 4
    _, ph, pw = m["patch_size"]
    total = 0.0
    h, w = h2, w2
    for cin, cout, s in ((o["num_keypoints"], h1, 1), (h1, hid2, 2),
                         (hid2, c4, 2)):
        h, w = (h + s - 1) // s, (w + s - 1) // s
        total += 2.0 * 27 * cin * cout * frames * h * w
    total += 2.0 * frames * h * w * (c4 * ph * pw) * m["dim"]
    return total


def audio_mlp_flops(o: dict, m: dict, n_audio: int) -> float:
    """Linear (audio_dim -> dim), Linear (dim -> dim), and the merge of
    each frame with the next (2 dim -> dim)."""
    dim = m["dim"]
    macs = n_audio * (o["audio_dim"] * dim + dim * dim)
    if n_audio > 1:
        macs += n_audio * 2 * dim * dim
    return 2.0 * macs


def adapter_flops(m: dict, n_tokens: int, n_audio: int) -> float:
    """The audio adapters of all blocks: q and o on the tokens, k and v on
    the audio tokens, attention of every token to every audio token."""
    dim = m["dim"]
    macs = 2 * dim * dim * (n_tokens + n_audio)
    return m["num_layers"] * (2.0 * macs + 4.0 * dim * n_tokens * n_audio)


def cond_forward_flops(o: dict, m: dict, n_video: int, n_extra: int,
                       text_len: int, n_audio: int,
                       pose_shape: Sequence[int]) -> float:
    """The conditional forward: the DiT over n_video + n_extra packed
    tokens (their patch embedding and head included), the adapters, the
    audio MLP and, with pose_shape (frames, 2h, 2w), the guider."""
    n = n_video + n_extra
    total = flops.dit_forward_flops(m, 1, n, [text_len])
    if n_audio:
        total += adapter_flops(m, n, n_audio) + audio_mlp_flops(o, m,
                                                                n_audio)
    if pose_shape is not None:
        total += pose_guider_flops(o, m, *pose_shape)
    return total


def step_flops(o: dict, m: dict, n_video: int, n_extra: int,
               text_lens: Sequence[int], n_audio: int,
               pose_shape: Sequence[int]) -> float:
    """One window step: the conditional forward (text_lens[0]) and the
    unconditional one over the video tokens (text_lens[1])."""
    return (cond_forward_flops(o, m, n_video, n_extra, text_lens[0],
                               n_audio, pose_shape)
            + flops.dit_forward_flops(m, 1, n_video, [text_lens[1]]))


def step_k1_bound_s(m: dict, seq_lens: Sequence[int], n_video: int,
                    n_extra: int, text_lens: Sequence[int],
                    n_audio: int) -> float:
    """Seconds of K1 bound in one window step: per block of the
    conditional forward (seq_lens[0] query rows) the self-attention over
    the packed tokens, the text and the audio cross-attention; the
    unconditional forward (seq_lens[1] rows) as `flops.dit_k1_bound_s`."""
    n, d = m["num_heads"], m["dim"] // m["num_heads"]
    lq = seq_lens[0]
    per_block = (flops.attention_bound(1, lq, n, d, [n_video + n_extra])[0]
                 + flops.attention_bound(1, lq, n, d, [text_lens[0]])[0])
    if n_audio:
        per_block += flops.attention_bound(1, lq, n, d, [n_audio])[0]
    return (m["num_layers"] * per_block
            + flops.dit_k1_bound_s(m, 1, seq_lens[1], n_video,
                                   [text_lens[1]]))
