"""The port's xLSTM (xlstm-350m, the ``ssm`` family) against the reference,
on identical parameters and inputs.

The reduced config in f32 (one mLSTM/sLSTM pair, d = 64, 4 heads).
Parameters are drawn once (the port's seeded init, as numpy) and
carried into both packages, into the port with ``params_from_reference``;
tokens, gate pre-activations and states come from numpy seeds.  Prompts of 16
(the ragged path only), 128 (one aligned chunk) and 130 (a chunk and a
ragged tail of 2) reach every prefill path.  Tolerances: block outputs
and the chunkwise cell rtol/atol 1e-5; logits, state leaves and
gradients 1e-4 (the same f32 math summed in other orders).  A decode
step against the port's own forward: 3e-3, as
``tests/test_arch_smoke.py`` holds the reference.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import xlstm
from repro_torch.models.state import flatten, params_from_reference, params_to_reference
from repro_torch.train.steps import loss_and_grads, make_loss_fn

ARCH = "xlstm-350m"
B = 2
PROMPTS = (16, 128, 130)
FORWARD_LENS = (16, 130)
STEPS = 3
CELL_S = 256  # two chunks


def _cfg():
    return get_config(ARCH).reduced()


def _leaf_names() -> list[str]:
    return list(flatten(xlstm.init_params(_cfg(), 0, "cpu")))


def _cell_inputs(seed):
    """q/k/v (B, S, H, hd), gates (B, S, H) and a non-zero state; k scaled
    by 1/sqrt(hd), as ``_mlstm_qkv`` hands it to the cell."""
    rng = np.random.default_rng(seed)
    H, hd = 4, 16
    f32 = np.float32
    qkv = [rng.normal(size=(B, CELL_S, H, hd)).astype(f32) for _ in range(3)]
    qkv[1] = (qkv[1] / np.sqrt(hd)).astype(f32)
    log_i = rng.normal(size=(B, CELL_S, H)).astype(f32)
    log_f = np.log(1 / (1 + np.exp(-(rng.normal(size=(B, CELL_S, H)) + 3)))).astype(f32)
    state = (
        rng.normal(size=(B, H, hd, hd)).astype(f32),
        rng.normal(size=(B, H, hd)).astype(f32),
        rng.normal(size=(B, H)).astype(f32),
    )
    return (*qkv, log_i, log_f), state


def _slstm_inputs(seed, d=64, S=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    H, hd = 4, d // 4
    state = tuple(rng.normal(size=(B, H, hd)).astype(np.float32) for _ in range(4))
    return x, (state[0], np.abs(state[1]) + 1, state[2], state[3])


@pytest.fixture(scope="module")
def ref():
    """The reference's params, cell and block outputs, forwards, prefills
    with STEPS greedy decode steps each, loss and gradients (jitted once
    per shape, shared by every test here)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.launch.specs import demo_batch as ref_demo_batch
    from repro.models import xlstm as rx
    from repro.train.steps import make_loss_fn as ref_loss_fn

    cfg = ref_get_config(ARCH).reduced()
    out = SimpleNamespace(params=params_to_reference(xlstm.init_params(_cfg(), 3, "cpu")))
    params = jax.tree.map(jnp.asarray, out.params)

    xs, st = _cell_inputs(1)
    out.cell = [np.asarray(a) for a in jax.tree.leaves(rx.mlstm_chunkwise(*xs, st))]
    x, sst = _slstm_inputs(2)
    lp = jax.tree.map(lambda a: a[0], params["pairs"]["s"])
    out.slstm = [np.asarray(a) for a in jax.tree.leaves(rx.slstm_block_fwd(lp, x, cfg, sst))]

    rng = np.random.default_rng(5)
    out.tokens = {S: rng.integers(0, cfg.vocab, (B, S)) for S in PROMPTS}
    fwd = jax.jit(lambda p, t: rx.forward(cfg, p, t))
    out.forward = {S: np.asarray(fwd(params, out.tokens[S])) for S in FORWARD_LENS}
    pf = jax.jit(lambda p, t: rx.prefill(cfg, p, t))
    dc = jax.jit(lambda p, s, t: rx.decode_step(cfg, p, s, t))
    out.serving = {}
    for S in PROMPTS:
        logits, state = pf(params, jnp.asarray(out.tokens[S], jnp.int32))
        logs, states, ids = [], [], []
        for step in range(STEPS + 1):
            if step:
                logits, state = dc(params, state, ids[-1])
            logs.append(np.asarray(logits))
            states.append({k: np.asarray(v) for k, v in flatten(state).items()})
            ids.append(jnp.argmax(logits[:, -1:], -1).astype(jnp.int32))
        out.serving[S] = SimpleNamespace(logits=logs, states=states, ids=[np.asarray(i) for i in ids])

    batch = ref_demo_batch(cfg, B, 16, seed=7)
    loss, grads = jax.jit(jax.value_and_grad(ref_loss_fn(cfg)))(params, batch)
    out.batch = jax.tree.map(np.asarray, batch)
    out.loss = float(loss)
    out.grads = {k: np.asarray(v) for k, v in flatten(grads).items()}
    return out


@pytest.fixture(scope="module")
def port(ref):
    """The port on the same parameters: prefill and decode fed the
    reference's ids (so one near-tie cannot fork the runs), the loss and
    every gradient."""
    cfg = _cfg()
    params = params_from_reference(ref.params, device="cpu")
    out = SimpleNamespace(cfg=cfg, params=params, serving={})
    for S in PROMPTS:
        r = ref.serving[S]
        logits, state = xlstm.prefill(cfg, params, torch.from_numpy(ref.tokens[S]))
        logs = [logits.numpy()]
        states = [{k: v.clone().numpy() for k, v in flatten(state).items()}]
        for step in range(1, STEPS + 1):
            nxt = torch.tensor(r.ids[step - 1], dtype=torch.long)
            logits, state = xlstm.decode_step(cfg, params, state, nxt, S + step - 1)
            logs.append(logits.numpy())
            states.append({k: v.clone().numpy() for k, v in flatten(state).items()})
        out.serving[S] = SimpleNamespace(logits=logs, states=states)
    batch = {
        "inputs": {"tokens": torch.tensor(ref.batch["inputs"]["tokens"], dtype=torch.long)},
        "labels": torch.tensor(ref.batch["labels"], dtype=torch.long),
    }
    loss, grads = loss_and_grads(make_loss_fn(cfg), params, batch)
    out.loss = float(loss)
    out.grads = dict(zip(flatten(params), (g.numpy() for g in grads)))
    return out


def test_mlstm_chunkwise_matches_reference(ref):
    """Two chunks from a non-zero state: outputs and the carried (C, n, m)."""
    xs, st = _cell_inputs(1)
    h, state = xlstm.mlstm_chunkwise(*map(torch.from_numpy, xs), tuple(map(torch.from_numpy, st)))
    for got, want in zip([h, *state], ref.cell):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_mlstm_chunkwise_matches_the_recurrent_oracle():
    """The port's chunkwise form against its own step-by-step recurrence."""
    xs, st = _cell_inputs(1)
    xs, st = tuple(map(torch.from_numpy, xs)), tuple(map(torch.from_numpy, st))
    h_c, s_c = xlstm.mlstm_chunkwise(*xs, st)
    h_r, s_r = xlstm.mlstm_recurrent(*xs, st)
    for got, want in zip([h_c, *s_c], [h_r, *s_r]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_mlstm_chunkwise_refuses_a_ragged_length():
    xs, st = _cell_inputs(1)
    xs = [torch.from_numpy(a[:, :130]) for a in xs]
    with pytest.raises(ValueError, match="multiple of 128"):
        xlstm.mlstm_chunkwise(*xs, tuple(map(torch.from_numpy, st)))


def test_slstm_block_matches_reference(ref):
    x, sst = _slstm_inputs(2)
    lp = {k: v[0] for k, v in params_from_reference(ref.params, "cpu")["pairs"]["s"].items()}
    out, state = xlstm.slstm_block_fwd(lp, torch.from_numpy(x), _cfg(), tuple(map(torch.from_numpy, sst)))
    for got, want in zip([out, *state], ref.slstm):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", FORWARD_LENS)
def test_forward_matches_reference(ref, port, S):
    with torch.no_grad():
        got = xlstm.forward(port.cfg, port.params, torch.from_numpy(ref.tokens[S])).numpy()
    assert got.shape == (B, S, port.cfg.vocab)
    np.testing.assert_allclose(got, ref.forward[S], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S", PROMPTS)
def test_prefill_matches_reference(ref, port, S):
    """Logits and every state leaf (C, n, m of the mLSTM; c, n, m, h of the
    sLSTM, stacked per pair)."""
    r, g = ref.serving[S], port.serving[S]
    assert g.logits[0].shape == (B, 1, port.cfg.vocab)
    np.testing.assert_allclose(g.logits[0], r.logits[0], rtol=1e-4, atol=1e-4)
    assert list(g.states[0]) == list(r.states[0])
    for k, want in r.states[0].items():
        assert g.states[0][k].dtype == np.float32
        np.testing.assert_allclose(g.states[0][k], want, rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("S", PROMPTS)
def test_decode_steps_match_reference(ref, port, S):
    r, g = ref.serving[S], port.serving[S]
    for step in range(1, STEPS + 1):
        np.testing.assert_allclose(
            g.logits[step], r.logits[step], rtol=1e-4, atol=1e-4, err_msg=f"step {step}"
        )
        for k, want in r.states[step].items():
            np.testing.assert_allclose(
                g.states[step][k], want, rtol=1e-4, atol=1e-4, err_msg=f"step {step} {k}"
            )


def test_loss_matches_reference(ref, port):
    assert port.loss == pytest.approx(ref.loss, rel=1e-5)


@pytest.mark.parametrize("leaf", _leaf_names())
def test_gradient_leaf_matches_reference(ref, port, leaf):
    got, want = port.grads[leaf], ref.grads[leaf]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_remat_gives_the_same_gradients(port):
    cfg = port.cfg.with_(remat=True)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab, (B, 17)))
    batch = {"inputs": {"tokens": tokens[:, :-1]}, "labels": tokens[:, 1:]}
    want = loss_and_grads(make_loss_fn(port.cfg), port.params, batch)
    got = loss_and_grads(make_loss_fn(cfg), port.params, batch)
    assert float(got[0]) == float(want[0])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-7)


def test_leaves_line_up_with_the_reference():
    """The port's init has the reference tree's paths, shapes and dtypes
    (bf16 parameters), its constant leaves equal the reference's, and a
    reference bf16 tree crosses over leaf for leaf."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.models import xlstm as rx

    rcfg = ref_get_config(ARCH).reduced().with_(param_dtype="bfloat16")
    key = jax.random.PRNGKey(0)
    want = flatten(jax.eval_shape(lambda k: rx.init_params(rcfg, k)[0], key))
    fresh = flatten(xlstm.init_params(_cfg().with_(param_dtype="bfloat16"), 1, "cpu"))
    assert list(fresh) == list(want)
    for k, w in want.items():
        assert tuple(fresh[k].shape) == w.shape and str(fresh[k].dtype) == f"torch.{w.dtype}", k
    p = jax.jit(lambda k: rx.init_pair(rcfg, k)[0])(key)
    for name in ("m/b_i", "m/b_f", "m/norm", "s/b", "s/norm"):
        blk, leaf = name.split("/")
        np.testing.assert_array_equal(
            fresh[f"pairs/{name}"][0].float().numpy(), np.asarray(p[blk][leaf], np.float32)
        )
    carried = flatten(params_from_reference({k: jnp.ones(w.shape, w.dtype) for k, w in want.items()}, "cpu"))
    assert all(str(carried[k].dtype) == f"torch.{w.dtype}" for k, w in want.items())


def test_decode_writes_the_state_in_place(port):
    """C13: ``decode_step`` writes the state it is given and returns the
    same dict of the same tensors; the offset is ignored."""
    cfg, params = port.cfg, port.params
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (B, 5)))
    _, state = xlstm.prefill(cfg, params, tokens)
    leaves = flatten(state)
    before = {k: v.clone() for k, v in leaves.items()}
    logits, out = xlstm.decode_step(cfg, params, state, tokens[:, :1], offset=None)
    assert out is state and all(a is b for a, b in zip(flatten(out).values(), leaves.values()))
    assert all(not torch.equal(v, before[k]) for k, v in leaves.items())
    _, fresh = xlstm.prefill(cfg, params, tokens)
    again, _ = xlstm.decode_step(cfg, params, fresh, tokens[:, :1], offset=123)
    torch.testing.assert_close(again, logits, rtol=0, atol=0)
