"""The port's Whisper encoder-decoder (whisper-medium, the ``audio``
family) against the reference, on identical parameters and inputs.

The reduced config in f32 (2 encoder and 2 decoder layers, d = 64).
Parameters are drawn once (the port's seeded init, as numpy) and carried
into both packages; tokens and frame embeddings (more frames than
tokens) come from numpy seeds.  Tolerances: the encoder's output rtol/atol
1e-5; logits, cache leaves and gradients 1e-4 (the same f32 math summed
in other orders).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import encdec
from repro_torch.models.state import flatten, params_from_reference, params_to_reference
from repro_torch.train.steps import loss_and_grads, make_loss_fn

ARCH = "whisper-medium"
B, S, FRAMES, STEPS = 2, 10, 24, 3


def _cfg():
    return get_config(ARCH).reduced()


def _leaf_names() -> list[str]:
    return list(flatten(encdec.init_params(_cfg(), 0, "cpu")))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, _cfg().vocab, (B, S))
    frames = rng.normal(size=(B, FRAMES, _cfg().d_model)).astype(np.float32)
    return tokens, frames


@pytest.fixture(scope="module")
def ref():
    """The reference's encoder output, forward, prefill with STEPS greedy
    decode steps, loss and gradients (jitted once each)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.launch.specs import demo_batch as ref_demo_batch
    from repro.models import encdec as re
    from repro.train.steps import make_loss_fn as ref_loss_fn

    cfg = ref_get_config(ARCH).reduced()
    out = SimpleNamespace(params=params_to_reference(encdec.init_params(_cfg(), 4, "cpu")))
    params = jax.tree.map(jnp.asarray, out.params)
    tokens, frames = _inputs(5)
    out.encode = np.asarray(jax.jit(lambda p, f: re.encode(cfg, p, f))(params, frames))
    out.forward = np.asarray(jax.jit(lambda p, t, f: re.forward(cfg, p, t, f))(params, tokens, frames))
    pf = jax.jit(lambda p, t, f: re.prefill(cfg, p, t, f, S + STEPS + 1))
    dc = jax.jit(lambda p, c, t, o: re.decode_step(cfg, p, c, t, o))
    logits, cache = pf(params, jnp.asarray(tokens, jnp.int32), frames)
    out.logits, out.caches, ids = [], [], []
    for step in range(STEPS + 1):
        if step:
            logits, cache = dc(params, cache, ids[-1], S + step - 1)
        out.logits.append(np.asarray(logits))
        out.caches.append({k: np.asarray(v) for k, v in cache.items()})
        ids.append(jnp.argmax(logits[:, -1:], -1).astype(jnp.int32))
    out.ids = [np.asarray(i) for i in ids]

    batch = ref_demo_batch(cfg, B, 12, seed=7)
    loss, grads = jax.jit(jax.value_and_grad(ref_loss_fn(cfg)))(params, batch)
    out.batch = jax.tree.map(np.asarray, batch)
    out.loss = float(loss)
    out.grads = {k: np.asarray(v) for k, v in flatten(grads).items()}
    return out


@pytest.fixture(scope="module")
def port(ref):
    cfg = _cfg()
    params = params_from_reference(ref.params, device="cpu")
    tokens, frames = map(torch.from_numpy, _inputs(5))
    out = SimpleNamespace(cfg=cfg, params=params, frames=frames)
    with torch.no_grad():
        out.encode = encdec.encode(cfg, params, frames).numpy()
        out.forward = encdec.forward(cfg, params, tokens, frames).numpy()
    logits, cache = encdec.prefill(cfg, params, tokens, frames, S + STEPS + 1)
    out.logits = [logits.numpy()]
    out.caches = [{k: v.clone().numpy() for k, v in cache.items()}]
    for step in range(1, STEPS + 1):
        nxt = torch.tensor(ref.ids[step - 1], dtype=torch.long)
        logits, cache = encdec.decode_step(cfg, params, cache, nxt, S + step - 1)
        out.logits.append(logits.numpy())
        out.caches.append({k: v.clone().numpy() for k, v in cache.items()})
    batch = {
        "inputs": {
            "tokens": torch.tensor(ref.batch["inputs"]["tokens"], dtype=torch.long),
            "frames": torch.tensor(ref.batch["inputs"]["frames"]),
        },
        "labels": torch.tensor(ref.batch["labels"], dtype=torch.long),
    }
    loss, grads = loss_and_grads(make_loss_fn(cfg), params, batch)
    out.loss = float(loss)
    out.grads = dict(zip(flatten(params), (g.numpy() for g in grads)))
    return out


def test_encode_matches_reference(ref, port):
    assert port.encode.shape == (B, FRAMES, 64)
    np.testing.assert_allclose(port.encode, ref.encode, rtol=1e-5, atol=1e-5)


def test_forward_matches_reference(ref, port):
    assert port.forward.shape == (B, S, port.cfg.vocab)
    np.testing.assert_allclose(port.forward, ref.forward, rtol=1e-4, atol=1e-4)


def test_prefill_matches_reference(ref, port):
    """Logits, the self K/V cache and ``enc_out``."""
    np.testing.assert_allclose(port.logits[0], ref.logits[0], rtol=1e-4, atol=1e-4)
    assert sorted(port.caches[0]) == sorted(ref.caches[0]) == ["enc_out", "k", "v"]
    for k, want in ref.caches[0].items():
        assert port.caches[0][k].shape == want.shape, k
        np.testing.assert_allclose(port.caches[0][k], want, rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_decode_step_matches_reference(ref, port, step):
    np.testing.assert_allclose(port.logits[step], ref.logits[step], rtol=1e-4, atol=1e-4)
    for k, want in ref.caches[step].items():
        np.testing.assert_allclose(port.caches[step][k], want, rtol=1e-4, atol=1e-4, err_msg=k)


def test_loss_matches_reference(ref, port):
    assert port.loss == pytest.approx(ref.loss, rel=1e-5)


@pytest.mark.parametrize("leaf", _leaf_names())
def test_gradient_leaf_matches_reference(ref, port, leaf):
    got, want = port.grads[leaf], ref.grads[leaf]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_sinusoid_is_built_once_per_device(ref, port, monkeypatch):
    """The encoder's position table is the reference's and is copied to
    the device once per (length, d, device), not on every ``encode``."""
    from repro.models import encdec as re

    table = encdec._sinusoid(FRAMES, 64, torch.device("cpu"))
    np.testing.assert_array_equal(table.numpy(), np.asarray(re._sinusoid(FRAMES, 64)))
    calls = []
    monkeypatch.setattr(np, "concatenate", lambda *a, **k: calls.append(1))
    encdec.encode(port.cfg, port.params, port.frames)
    assert encdec._sinusoid(FRAMES, 64, torch.device("cpu")) is table and calls == []


def test_leaves_line_up_with_the_reference():
    """The port's init has the reference tree's paths, shapes and dtypes
    (bf16 parameters); a reference bf16 tree crosses over with its dtypes."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.models import encdec as re

    rcfg = ref_get_config(ARCH).reduced().with_(param_dtype="bfloat16")
    want = flatten(jax.eval_shape(lambda k: re.init_params(rcfg, k)[0], jax.random.PRNGKey(0)))
    fresh = flatten(encdec.init_params(_cfg().with_(param_dtype="bfloat16"), 1, "cpu"))
    assert list(fresh) == list(want)
    for k, w in want.items():
        assert tuple(fresh[k].shape) == w.shape and str(fresh[k].dtype) == f"torch.{w.dtype}", k
    assert fresh["dec_pos"].shape[0] == encdec.MAX_DEC_POS == re.MAX_DEC_POS
    carried = flatten(params_from_reference({k: jnp.ones(w.shape, w.dtype) for k, w in want.items()}, "cpu"))
    assert all(str(carried[k].dtype) == f"torch.{w.dtype}" for k, w in want.items())


def test_decode_writes_the_cache_in_place(port):
    """C11 for this family: ``decode_step`` writes the self K/V it is given
    and returns the same dict of the same tensors."""
    tokens, frames = map(torch.from_numpy, _inputs(6))
    _, cache = encdec.prefill(port.cfg, port.params, tokens, frames, S + 2)
    tensors = dict(cache)
    k_before = cache["k"].clone()
    _, out = encdec.decode_step(port.cfg, port.params, cache, tokens[:, :1], S)
    assert out is cache and all(out[k] is tensors[k] for k in tensors)
    assert torch.equal(cache["k"][:, :, :S], k_before[:, :, :S])
    assert not torch.equal(cache["k"][:, :, S], k_before[:, :, S])


def test_decoder_position_past_the_table_raises(port):
    """C14: the reference's ``dynamic_slice_in_dim`` clamps a start past
    ``MAX_DEC_POS - S`` and reuses the last rows of the table; the port
    raises ``ValueError``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.models import encdec as re

    rcfg = ref_get_config(ARCH).reduced()
    small = {**params_to_reference(port.params), "dec_pos": np.arange(8 * 64, dtype=np.float32).reshape(8, 64)}
    tokens = np.zeros((1, 3), np.int64)
    enc = jnp.zeros((1, 4, 64))
    jp = jax.tree.map(jnp.asarray, small)
    clamped, _ = re.decode_stack(rcfg, jp, jnp.asarray(tokens, jnp.int32), enc, offset=6)
    at_end, _ = re.decode_stack(rcfg, jp, jnp.asarray(tokens, jnp.int32), enc, offset=5)
    np.testing.assert_array_equal(np.asarray(clamped), np.asarray(at_end))  # rows 5..7, not 6..8
    tp = params_from_reference(small, "cpu")
    with torch.no_grad():
        got = encdec.decode_stack(port.cfg, tp, torch.from_numpy(tokens), torch.zeros(1, 4, 64), offset=5)
        np.testing.assert_allclose(got.numpy(), np.asarray(at_end), rtol=1e-4, atol=1e-4)
        with pytest.raises(ValueError, match="outside a table of 8"):
            encdec.decode_stack(port.cfg, tp, torch.from_numpy(tokens), torch.zeros(1, 4, 64), offset=6)
    cache = encdec.init_kv_cache(port.cfg, 1, 4, 4, device="cpu")
    with pytest.raises(ValueError, match="outside a table"):
        encdec.decode_step(port.cfg, port.params, cache, torch.zeros((1, 1), dtype=torch.long), encdec.MAX_DEC_POS)

