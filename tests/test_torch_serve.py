"""The port's serving driver against ``repro.launch.serve`` on the CPU,
with the params and prompts that the reference's ``main`` draws at seed 0
carried across as numpy arrays.

float32: the same greedy ids. bf16: the frameworks round at different
places, so greedy picks may part where two logits nearly tie; the test
feeds both the reference's ids (teacher forcing) and holds the logits to
twice the reference's own bf16 error against its float32 evaluation of the
same weights (the bound of ``test_torch_rwkv6.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import replace as jreplace
from repro.configs import get_smoke_config as jsmoke
from repro.launch import serve as jserve
from repro.models import build_model as jbuild
from repro_torch.config import replace as treplace
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild

ARGS = ["--arch", "rwkv6-1.6b", "--preset", "smoke", "--batch", "3",
        "--prompt-len", "20", "--gen", "10", "--seed", "0"]
B, S, GEN = 3, 20, 10
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _reference_draws(cfg):
    """What ``repro.launch.serve.main`` draws at seed 0 (serve.py:38-41)."""
    rng = jax.random.PRNGKey(0)
    params = jbuild(cfg).init(rng)
    prompts = jax.random.randint(rng, (B, S), 0, cfg.vocab_size)
    return params, np.array(prompts)


def test_serve_gives_the_reference_ids_in_float32(monkeypatch):
    jcfg = jreplace(jsmoke("rwkv6-1.6b"), **F32)
    monkeypatch.setattr(jserve, "get_smoke_config", lambda arch: jcfg)
    want = jserve.main(ARGS)
    params, prompts = _reference_draws(jcfg)
    tcfg = treplace(tsmoke("rwkv6-1.6b"), **F32)
    got = tserve.serve(tbuild(tcfg),
                       params_from_numpy(jax.tree.map(np.asarray, params),
                                         "cpu"), prompts, GEN, "cpu")
    assert got["ids"].shape == (B, GEN) and got["finite"]
    np.testing.assert_array_equal(got["ids"], want)
    assert got["ids"].max() >= 256   # the argmax runs over padded columns


def _teacher_forced(model, params, prompts, ids, as_array, pos):
    logits, st = model.prefill(params, {"tokens": as_array(prompts)})
    out = [logits[:, -1]]
    for i in range(ids.shape[1] - 1):
        logits, st = model.decode_step(
            params, {"token": as_array(ids[:, i]), "pos": pos(S + i)}, st)
        out.append(logits)
    return out


def test_serve_bf16_logits_track_the_reference():
    want_ids = jserve.main(ARGS)
    jcfg = jsmoke("rwkv6-1.6b")
    params, prompts = _reference_draws(jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    tmodel = tbuild(tsmoke("rwkv6-1.6b"))
    got = tserve.serve(tmodel, tp, prompts, GEN, "cpu")
    assert got["ids"].shape == (B, GEN) and got["finite"]
    assert got["ids"][:, 0].tolist() == want_ids[:, 0].tolist()
    with torch.inference_mode():
        tl = _teacher_forced(tmodel, tp, prompts, want_ids, torch.from_numpy,
                             int)
    jl = _teacher_forced(jbuild(jcfg), params, prompts, want_ids,
                         jnp.asarray, jnp.int32)
    j32 = _teacher_forced(
        jbuild(jreplace(jcfg, **F32)),
        jax.tree.map(lambda a: a.astype(jnp.float32), params), prompts,
        want_ids, jnp.asarray, jnp.int32)
    for step, (t, j, f) in enumerate(zip(tl, jl, j32)):
        t = t.float().numpy()
        j, f = np.asarray(j, np.float32), np.asarray(f, np.float32)
        tol = max(2.0 * np.abs(j - f).max(), 2.0 ** -7 * np.abs(j).max())
        assert np.abs(t - j).max() <= tol, step
        # where the reference's pick leads by more than 2 tol, the port's
        # greedy pick is the same
        top2 = np.sort(j, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * tol
        assert np.array_equal(t.argmax(-1)[sure], j.argmax(-1)[sure]), step


def test_main_runs_on_the_cpu(capsys):
    ids = tserve.main(["--arch", "rwkv6-1.6b", "--device", "cpu", "--batch",
                       "2", "--prompt-len", "8", "--gen", "4"])
    assert ids.shape == (2, 4)
    out = capsys.readouterr().out
    assert "device=cpu" in out and "prefill:" in out and "decode:" in out


def test_main_defaults_to_the_gpu():
    """Without ``--device`` the driver serves on ``cuda``; with no card it
    raises rather than carrying on on the CPU."""
    args = ["--arch", "rwkv6-1.6b", "--batch", "1", "--prompt-len", "4",
            "--gen", "2"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(args)
        return
    assert tserve.main(args).shape == (1, 2)


def test_other_families_wait_for_their_slice(capsys):
    """No family waits any more: the CLI serves the moe, hybrid and encdec
    smoke presets on the CPU (``encdec`` fed the frames that ``main``
    draws); ``test_torch_moe.py``, ``test_torch_rglru.py`` and
    ``test_torch_encdec.py`` hold them to the reference."""
    for arch in ("mixtral-8x7b", "recurrentgemma-9b", "seamless-m4t-medium"):
        ids = tserve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                           "--prompt-len", "16", "--gen", "4"])
        assert ids.shape == (2, 4)
        assert f"arch={arch}" in capsys.readouterr().out
