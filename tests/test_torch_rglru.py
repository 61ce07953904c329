"""The port's RG-LRU hybrid (recurrentgemma-2b, the ``hybrid`` family)
against the reference, on identical parameters and inputs.

Two reduced configs in f32 (d = 64, window 16): the reduced default of 3
layers (one triple, no remainder) and 5 layers (a triple plus ``rem0``
and ``rem1``).  Parameters are drawn once (the port's seeded init, as
numpy) and carried into both packages; inputs come from numpy seeds.  A
prompt of 10 leaves the ring (W = min(max_len, 16) = 14) part empty; a
prompt of 40 fills it from its last 16 positions and the decode steps
overwrite its oldest slots.  ``_rglru`` runs at S = 4100: two chunks of
4096, the second padded with identity steps.  Tolerances: the scan and
block outputs rtol/atol 1e-5; logits, state leaves and gradients 1e-4
(the same f32 math summed in other orders: the port's Hillis-Steele scan
is not XLA's associative scan).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import rglru
from repro_torch.models.state import flatten, params_from_reference, params_to_reference
from repro_torch.train.steps import loss_and_grads, make_loss_fn

ARCH = "recurrentgemma-2b"
B = 2
LAYERS = (3, 5)
RUNS = ((3, 10), (3, 40), (5, 40))  # (layers, prompt)
STEPS = 3
SCAN_S = 4100


def _cfg(layers=3):
    cfg = get_config(ARCH).reduced()
    return cfg if layers == 3 else cfg.with_(n_layers=layers)


def _leaf_names() -> list[str]:
    return list(flatten(rglru.init_params(_cfg(5), 0, "cpu")))


def _scan_inputs(seed, dr=64):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, SCAN_S, dr)).astype(np.float32)
    h0 = rng.normal(size=(B, dr)).astype(np.float32)
    return u, h0


def _block_inputs(seed, d=64, S=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    h0 = rng.normal(size=(B, d)).astype(np.float32)
    conv = rng.normal(size=(B, 3, d)).astype(np.float32)
    return x, h0, conv


@pytest.fixture(scope="module")
def ref():
    """The reference's scan, block, forwards, prefills with STEPS greedy
    decode steps, loss and gradients (jitted once per shape)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.launch.specs import demo_batch as ref_demo_batch
    from repro.models import rglru as rr
    from repro.train.steps import make_loss_fn as ref_loss_fn

    out = SimpleNamespace(params={}, forward={}, serving={})
    cfgs = {n: ref_get_config(ARCH).reduced().with_(n_layers=n) for n in LAYERS}
    for n in LAYERS:
        out.params[n] = params_to_reference(rglru.init_params(_cfg(n), 10 + n, "cpu"))
    params = {n: jax.tree.map(jnp.asarray, out.params[n]) for n in LAYERS}
    rec = jax.tree.map(lambda a: a[0], params[3]["triples"]["rec1"])

    out.scan = [np.asarray(a) for a in jax.jit(rr._rglru)(rec, *_scan_inputs(1))]
    x, h0, conv = _block_inputs(2)
    blk = jax.jit(lambda p, x, h, c: rr.recurrent_block_fwd(p, x, cfgs[3], h, c))
    out.block = {
        tail: [np.asarray(a) for a in jax.tree.leaves(blk(rec, x, h0, conv if tail else None))]
        for tail in (False, True)
    }

    rng = np.random.default_rng(5)
    out.tokens = {S: rng.integers(0, cfgs[3].vocab, (B, S)) for S in {s for _, s in RUNS}}
    for n in LAYERS:
        fwd = jax.jit(lambda p, t, c=cfgs[n]: rr.forward(c, p, t))
        out.forward[n] = np.asarray(fwd(params[n], out.tokens[40]))
    for n, S in RUNS:
        cfg = cfgs[n]
        pf = jax.jit(lambda p, t, c=cfg, m=S + STEPS + 1: rr.prefill(c, p, t, m))
        dc = jax.jit(lambda p, s, t, o, c=cfg: rr.decode_step(c, p, s, t, o))
        logits, state = pf(params[n], jnp.asarray(out.tokens[S], jnp.int32))
        logs, states, ids = [], [], []
        for step in range(STEPS + 1):
            if step:
                logits, state = dc(params[n], state, ids[-1], S + step - 1)
            logs.append(np.asarray(logits))
            states.append({k: np.asarray(v) for k, v in flatten(state).items()})
            ids.append(jnp.argmax(logits[:, -1:], -1).astype(jnp.int32))
        out.serving[n, S] = SimpleNamespace(logits=logs, states=states, ids=[np.asarray(i) for i in ids])

    batch = ref_demo_batch(cfgs[5], B, 16, seed=7)
    loss, grads = jax.jit(jax.value_and_grad(ref_loss_fn(cfgs[5])))(params[5], batch)
    out.batch = jax.tree.map(np.asarray, batch)
    out.loss = float(loss)
    out.grads = {k: np.asarray(v) for k, v in flatten(grads).items()}
    return out


@pytest.fixture(scope="module")
def port(ref):
    """The port on the same parameters: prefill and decode fed the
    reference's ids, the loss and every gradient of the 5-layer config."""
    out = SimpleNamespace(params={}, serving={})
    for n in LAYERS:
        out.params[n] = params_from_reference(ref.params[n], device="cpu")
    for n, S in RUNS:
        cfg, params, r = _cfg(n), out.params[n], ref.serving[n, S]
        logits, state = rglru.prefill(cfg, params, torch.from_numpy(ref.tokens[S]), S + STEPS + 1)
        logs = [logits.numpy()]
        states = [{k: v.clone().numpy() for k, v in flatten(state).items()}]
        for step in range(1, STEPS + 1):
            nxt = torch.tensor(r.ids[step - 1], dtype=torch.long)
            logits, state = rglru.decode_step(cfg, params, state, nxt, S + step - 1)
            logs.append(logits.numpy())
            states.append({k: v.clone().numpy() for k, v in flatten(state).items()})
        out.serving[n, S] = SimpleNamespace(logits=logs, states=states)
    batch = {
        "inputs": {"tokens": torch.tensor(ref.batch["inputs"]["tokens"], dtype=torch.long)},
        "labels": torch.tensor(ref.batch["labels"], dtype=torch.long),
    }
    loss, grads = loss_and_grads(make_loss_fn(_cfg(5)), out.params[5], batch)
    out.loss = float(loss)
    out.grads = dict(zip(flatten(out.params[5]), (g.numpy() for g in grads)))
    return out


def _rec1(params):
    return {k: v[0] for k, v in params["triples"]["rec1"].items()}


def test_rglru_matches_reference_over_two_chunks(ref, port):
    """S = 4100 from a non-zero carry: the outputs and the last carry."""
    u, h0 = _scan_inputs(1)
    y, h = rglru._rglru(_rec1(port.params[3]), torch.from_numpy(u), torch.from_numpy(h0))
    for name, got, want in (("y", y, ref.scan[0]), ("h_last", h, ref.scan[1])):
        err = float(np.max(np.abs(got.numpy() - want) / (1e-5 + 1e-5 * np.abs(want))))
        assert err <= 1, f"{name}: worst |got - want| / (1e-5 + 1e-5 |want|) = {err:.3g}"


def test_rglru_scan_is_log_depth(monkeypatch):
    """A chunk of S steps takes ceil(log2(S + 1)) rounds of the combine,
    not S steps."""
    rounds = []
    real = torch.cat
    monkeypatch.setattr(torch, "cat", lambda *a, **k: rounds.append(1) or real(*a, **k))
    a = torch.rand(1, 4096, 3)
    rglru._rglru_scan(a, torch.randn(1, 4096, 3), torch.zeros(1, 3))
    # two concatenations set up the carry; then one per round for b and
    # one per round but the last for a
    assert len(rounds) == 2 + 13 + 12


@pytest.mark.parametrize("tail", [False, True], ids=["no_conv_tail", "conv_tail"])
def test_recurrent_block_matches_reference(ref, port, tail):
    """The block's output, its last carry and its new conv tail, from zeros
    (prefill) or from a given tail (decode, here 12 tokens at once)."""
    x, h0, conv = map(torch.from_numpy, _block_inputs(2))
    out, (h, c) = rglru.recurrent_block_fwd(
        _rec1(port.params[3]), x, _cfg(), h0, conv if tail else None
    )
    for got, want in zip((out, h, c), ref.block[tail]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layers", LAYERS)
def test_forward_matches_reference(ref, port, layers):
    with torch.no_grad():
        got = rglru.forward(_cfg(layers), port.params[layers], torch.from_numpy(ref.tokens[40]))
    assert got.shape == (B, 40, 256)
    np.testing.assert_allclose(got.numpy(), ref.forward[layers], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("run", RUNS, ids=[f"L{n}_S{s}" for n, s in RUNS])
def test_prefill_matches_reference(ref, port, run):
    """Logits, the ring's K/V/pos, the carries and the conv tails."""
    r, g = ref.serving[run], port.serving[run]
    np.testing.assert_allclose(g.logits[0], r.logits[0], rtol=1e-4, atol=1e-4)
    assert list(g.states[0]) == list(r.states[0])
    for k, want in r.states[0].items():
        assert g.states[0][k].dtype == want.dtype, k
        np.testing.assert_allclose(g.states[0][k], want, rtol=1e-4, atol=1e-4, err_msg=k)
    pos = g.states[0]["triples/4/pos"]
    n, S = run
    W = min(S + STEPS + 1, 16)
    assert sorted(pos[0, 0].tolist()) == sorted([-1] * (W - min(W, S)) + list(range(S - min(W, S), S)))


@pytest.mark.parametrize("run", RUNS, ids=[f"L{n}_S{s}" for n, s in RUNS])
def test_decode_steps_match_reference(ref, port, run):
    r, g = ref.serving[run], port.serving[run]
    for step in range(1, STEPS + 1):
        np.testing.assert_allclose(
            g.logits[step], r.logits[step], rtol=1e-4, atol=1e-4, err_msg=f"step {step}"
        )
        for k, want in r.states[step].items():
            np.testing.assert_allclose(
                g.states[step][k], want, rtol=1e-4, atol=1e-4, err_msg=f"step {step} {k}"
            )
    if run[1] == 40:  # the steps overwrote the ring's oldest slots: 24..26 -> 40..42
        assert sorted(g.states[STEPS]["triples/4/pos"][0, 0].tolist()) == list(range(27, 43))


def test_loss_matches_reference(ref, port):
    assert port.loss == pytest.approx(ref.loss, rel=1e-5)


@pytest.mark.parametrize("leaf", _leaf_names())
def test_gradient_leaf_matches_reference(ref, port, leaf):
    got, want = port.grads[leaf], ref.grads[leaf]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_remat_gives_the_same_gradients(port):
    cfg = _cfg(5)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab, (B, 13)))
    batch = {"inputs": {"tokens": tokens[:, :-1]}, "labels": tokens[:, 1:]}
    want = loss_and_grads(make_loss_fn(cfg), port.params[5], batch)
    got = loss_and_grads(make_loss_fn(cfg.with_(remat=True)), port.params[5], batch)
    assert float(got[0]) == float(want[0])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-7)


def test_leaves_line_up_with_the_reference():
    """The port's init has the reference tree's paths, shapes and dtypes
    with bf16 parameters (``lam`` stays f32), and ``lam`` the reference's
    range; a reference bf16 tree crosses over with its dtypes."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.models import rglru as rr

    rcfg = ref_get_config(ARCH).reduced().with_(n_layers=5, param_dtype="bfloat16")
    want = flatten(jax.eval_shape(lambda k: rr.init_params(rcfg, k)[0], jax.random.PRNGKey(0)))
    fresh = flatten(rglru.init_params(_cfg(5).with_(param_dtype="bfloat16"), 1, "cpu"))
    assert list(fresh) == list(want)
    for k, w in want.items():
        assert tuple(fresh[k].shape) == w.shape and str(fresh[k].dtype) == f"torch.{w.dtype}", k
    assert fresh["rem1/rec/lam"].dtype == torch.float32
    a = torch.exp(-rglru.LRU_C * rglru._softplus(fresh["triples/rec1/lam"]))  # a at r = 1
    assert 0.9 <= float(a.min()) and float(a.max()) <= 0.999 + 1e-6
    carried = flatten(params_from_reference({k: jnp.ones(w.shape, w.dtype) for k, w in want.items()}, "cpu"))
    assert all(str(carried[k].dtype) == f"torch.{w.dtype}" for k, w in want.items())


def test_decode_writes_the_state_in_place():
    """C13: ``decode_step`` writes the carries, conv tails and ring it is
    given and returns the same containers of the same tensors; the
    offset is a host int."""
    cfg = _cfg(5)
    params = rglru.init_params(cfg, 0, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (B, 6)))
    _, state = rglru.prefill(cfg, params, tokens, 10)
    leaves = flatten(state)
    before = {k: v.clone() for k, v in leaves.items()}
    _, out = rglru.decode_step(cfg, params, state, tokens[:, :1], 6)
    assert out is state and all(a is b for a, b in zip(flatten(out).values(), leaves.values()))
    assert all(not torch.equal(v, before[k]) for k, v in leaves.items())
    with pytest.raises(TypeError, match="host int"):
        rglru.decode_step(cfg, params, state, tokens[:, :1], torch.tensor(7))
