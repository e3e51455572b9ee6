"""cli.train_apt's numpy draws against JAX's: the slow cases of
tests/test_torch_apt_cli.py (whose helpers they use), in a file of their
own so that a `--dist loadfile` run schedules them with the files of few
tests, beside the longest ones, instead of before them."""

import numpy as np

from omnihuman_tpu_torch.cli import train_apt
# fixtures and helpers of the file these cases came from
from test_torch_apt_cli import _apt_argv, teacher_npz


def test_train_apt_numpy_draws_match_jax(teacher_npz, tmp_path,
                                         monkeypatch):
    import jax.numpy as jnp

    import omnihuman_tpu.apt.apt_trainer as jtr
    import omnihuman_tpu.cli.train_apt as jcli
    import omnihuman_tpu.utils.checkpoint as jck

    def recorder(build, calls):
        def wrapped(data, sel, rng, *rest):
            batch = build(data, sel, rng, *rest)
            calls.append((np.array(sel), np.array(batch["noise"])))
            return batch
        return wrapped

    class NoCheckpoints:
        def __init__(self, *a, **k):
            pass

        def save(self, *a, **k):
            pass

        def wait(self):
            pass

    zero = lambda: jnp.zeros(())
    monkeypatch.setattr(jtr, "apt_d_step", lambda state, batch, key, **kw: (
        state, {"d_loss": zero(), "r1_loss": zero(), "d_total": zero()}))
    monkeypatch.setattr(jtr, "apt_g_step", lambda state, batch, key, **kw: (
        state, {"g_loss": zero()}))
    monkeypatch.setattr(jck, "CheckpointManager", NoCheckpoints)
    jax_calls, port_calls = [], []
    monkeypatch.setattr(jcli, "_build_batch",
                        recorder(jcli._build_batch, jax_calls))
    monkeypatch.setattr(train_apt, "_build_batch",
                        recorder(train_apt._build_batch, port_calls))
    argv = _apt_argv(teacher_npz, str(tmp_path / "j"))
    jcli.main(argv[:-2])                        # the JAX CLI has no --device
    train_apt.main(_apt_argv(teacher_npz, str(tmp_path / "p")))
    assert len(jax_calls) == len(port_calls) == 5
    for (js, jn), (ps, pn) in zip(jax_calls, port_calls):
        np.testing.assert_array_equal(ps, js)
        np.testing.assert_array_equal(pn, jn)
