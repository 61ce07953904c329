"""The port's dense transformer against the reference, on identical
parameters and tokens.

Two dense variants at reduced width in f32: starcoder2-3b (LayerNorm,
biases, ungated GELU) and granite-8b (RMSNorm, gated SiLU), two layers
each.  Reference parameters cross over with ``params_from_reference``;
tokens come from a numpy seed.  Tolerances: logits atol/rtol 1e-4 and
the loss rel 1e-5 (the same f32 math summed in another order); every
gradient leaf (torch autograd against ``jax.grad``) rtol 1e-3 with atol
1e-5, as backward sums run in yet other orders; naive against blockwise
attention 2e-5, the reference's own tolerance for that pair.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import layers as L
from repro_torch.models.registry import get_model
from repro_torch.models.state import flatten, params_from_reference, params_to_reference
from repro_torch.models.transformer import init_params
from repro_torch.train.steps import loss_and_grads, make_loss_fn

VARIANTS = {
    "starcoder2-3b": lambda c: c.reduced(),
    "granite-8b": lambda c: c.reduced().with_(n_layers=2),
}
B, S = 2, 16


def _cfg(arch):
    return VARIANTS[arch](get_config(arch))


def _leaf_names(arch) -> list[str]:
    return list(flatten(init_params(_cfg(arch), 0, "cpu")))


CASES = [(a, leaf) for a in VARIANTS for leaf in _leaf_names(a)]


@pytest.fixture(scope="module")
def ref_runs():
    """Per variant: the reference's params, logits, loss and gradients on
    one batch (one JAX evaluation each, shared by every test here)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.models import transformer as ref_tf
    from repro.train.steps import make_loss_fn as ref_loss_fn

    out = {}
    for arch, cut in VARIANTS.items():
        cfg = cut(ref_get_config(arch))
        params, _ = ref_tf.init_params(cfg, jax.random.PRNGKey(3))
        tokens = np.random.default_rng(5).integers(0, cfg.vocab, (B, S + 1))
        batch = {
            "inputs": {"tokens": jnp.asarray(tokens[:, :-1], jnp.int32)},
            "labels": jnp.asarray(tokens[:, 1:], jnp.int32),
        }
        logits = jax.jit(lambda p, t, c=cfg: ref_tf.forward(c, p, t))(
            params, batch["inputs"]["tokens"]
        )
        loss, grads = jax.jit(jax.value_and_grad(ref_loss_fn(cfg)))(params, batch)
        out[arch] = SimpleNamespace(
            params=jax.tree.map(np.asarray, params),
            tokens=tokens,
            logits=np.asarray(logits),
            loss=float(loss),
            grads={k: np.asarray(v) for k, v in flatten(grads).items()},
            jnp=jnp,
        )
    return out


@pytest.fixture(scope="module")
def port_runs(ref_runs):
    """The port on the same parameters and tokens."""
    out = {}
    for arch, r in ref_runs.items():
        cfg = _cfg(arch)
        params = params_from_reference(r.params, device="cpu")
        toks = torch.from_numpy(r.tokens)
        batch = {"inputs": {"tokens": toks[:, :-1]}, "labels": toks[:, 1:]}
        with torch.no_grad():
            logits = get_model(cfg).forward(cfg, params, toks[:, :-1])
        loss, grads = loss_and_grads(make_loss_fn(cfg), params, batch)
        out[arch] = SimpleNamespace(
            cfg=cfg,
            params=params,
            batch=batch,
            logits=logits.numpy(),
            loss=float(loss),
            grads=dict(zip(flatten(params), (g.numpy() for g in grads))),
        )
    return out


@pytest.mark.parametrize("arch", VARIANTS)
def test_logits_match_reference(ref_runs, port_runs, arch):
    got, want = port_runs[arch].logits, ref_runs[arch].logits
    assert got.shape == want.shape == (B, S, port_runs[arch].cfg.vocab)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", VARIANTS)
def test_loss_matches_reference(ref_runs, port_runs, arch):
    assert port_runs[arch].loss == pytest.approx(ref_runs[arch].loss, rel=1e-5)


@pytest.mark.parametrize("arch,leaf", CASES)
def test_gradient_leaf_matches_reference(ref_runs, port_runs, arch, leaf):
    got, want = port_runs[arch].grads[leaf], ref_runs[arch].grads[leaf]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("arch", VARIANTS)
def test_leaves_line_up_with_the_reference(ref_runs, port_runs, arch):
    """One port parameter per reference leaf, in the reference's flat
    order, same shapes; the carry-across is a plain copy both ways."""
    import jax

    ref_params = ref_runs[arch].params
    paths = [
        "/".join(str(k.key) for k in path)
        for path, _ in jax.tree_util.tree_leaves_with_path(ref_params)
    ]
    port = port_runs[arch].params
    assert list(flatten(port)) == paths
    back = flatten(params_to_reference(port))
    for k, v in flatten(ref_params).items():
        np.testing.assert_array_equal(back[k], v)
    fresh = flatten(init_params(port_runs[arch].cfg, 1, "cpu"))
    for k, v in flatten(ref_params).items():
        assert tuple(fresh[k].shape) == v.shape and str(fresh[k].dtype) == f"torch.{v.dtype}"


@pytest.mark.parametrize("arch", VARIANTS)
def test_remat_gives_the_same_gradients(port_runs, arch):
    r = port_runs[arch]
    cfg = r.cfg.with_(remat=True)
    loss, grads = loss_and_grads(make_loss_fn(cfg), r.params, r.batch)
    assert float(loss) == r.loss
    for k, g in zip(flatten(r.params), grads):
        np.testing.assert_allclose(g.numpy(), r.grads[k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("H,KV,S_", [(4, 4, 50), (8, 2, 50), (4, 2, 13)])
def test_blockwise_matches_naive(ref_runs, monkeypatch, window, H, KV, S_):
    """The online-softmax path over several KV blocks (a ragged last one)
    equals the naive path, and both equal the reference's."""
    import jax
    from repro.models import layers as ref_layers

    monkeypatch.setattr(L, "BLOCKWISE_KV_BLOCK", 8)
    monkeypatch.setattr(ref_layers, "BLOCKWISE_KV_BLOCK", 8)
    rng = np.random.default_rng(H * 100 + S_)
    hd = 16
    p = {
        "wq": rng.normal(size=(H * hd, H * hd)) / 8,
        "wk": rng.normal(size=(H * hd, KV * hd)) / 8,
        "wv": rng.normal(size=(H * hd, KV * hd)) / 8,
        "wo": rng.normal(size=(H * hd, H * hd)) / 8,
    }
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, S_, H * hd)).astype(np.float32)
    kw = dict(n_heads=H, n_kv_heads=KV, window=window)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    naive = L.attention_fwd(tp, torch.from_numpy(x), impl="naive", **kw).numpy()
    block = L.attention_fwd(tp, torch.from_numpy(x), impl="blockwise", **kw).numpy()
    np.testing.assert_allclose(block, naive, rtol=2e-5, atol=2e-5)
    jp = {k: ref_runs["granite-8b"].jnp.asarray(v) for k, v in p.items()}
    jx = ref_runs["granite-8b"].jnp.asarray(x)
    want, _ = jax.jit(lambda p_, x_: ref_layers.attention_fwd(p_, x_, impl="blockwise", **kw))(
        jp, jx
    )
    np.testing.assert_allclose(block, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_auto_attention_switches_at_the_reference_length(monkeypatch):
    calls = []
    real = L._blockwise_attention
    monkeypatch.setattr(
        L, "_blockwise_attention", lambda *a, **k: calls.append(1) or real(*a, **k)
    )
    monkeypatch.setattr(L, "BLOCKWISE_MIN_KV", 12)
    p = {k: torch.randn(64, 64) / 8 for k in ("wq", "wk", "wv", "wo")}
    for s, want in ((11, 0), (12, 1)):
        L.attention_fwd(p, torch.randn(1, s, 64), n_heads=4, n_kv_heads=4, impl="auto")
        assert len(calls) == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_the_reference_configs(arch):
    pytest.importorskip("jax")
    from dataclasses import asdict

    from repro.configs import get_config as ref_get_config

    assert asdict(get_config(arch)) == asdict(ref_get_config(arch))
    assert asdict(get_config(arch).reduced()) == asdict(ref_get_config(arch).reduced())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_resolves(arch):
    """Every arch id has a model with the registry's five entry points; its
    cache (or recurrent state) builds on the meta device."""
    cfg = get_config(arch)
    model = get_model(cfg)
    for name in ("init_params", "forward", "prefill", "decode_step", "init_kv_cache"):
        assert callable(getattr(model, name)), name
    cache = model.init_kv_cache(cfg, 1, 8, device="meta")
    assert all(t.device.type == "meta" for t in flatten(cache).values())
    assert cfg.pdtype == torch.bfloat16


# -- tests/test_arch_smoke.py:27,35 for the port: every family, reduced ------------


def _smoke_setup(arch):
    from repro_torch.launch.specs import demo_batch

    cfg = get_config(arch).reduced()
    model = get_model(cfg)
    return cfg, model, model.init_params(cfg, 0, "cpu"), demo_batch(cfg, B, S, device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_shapes_no_nan(arch):
    cfg, model, params, batch = _smoke_setup(arch)
    with torch.no_grad():
        logits = model.forward(cfg, params, **batch["inputs"])
    assert logits.shape == (B, S, cfg.vocab) and logits.dtype == torch.float32
    assert not bool(torch.isnan(logits).any())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_decreases_nothing_nan(arch):
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.steps import make_train_step

    cfg, _, params, batch = _smoke_setup(arch)
    opt_cfg = OptimizerConfig(lr=1e-3)
    step = make_train_step(cfg, opt_cfg)
    opt_state = init_opt_state(params, opt_cfg)
    before = {k: v.clone() for k, v in flatten(params).items()}
    params, opt_state, metrics = step(params, opt_state, batch)
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert any(not torch.allclose(v, before[k]) for k, v in flatten(params).items())
    _, _, m2 = step(params, opt_state, batch)
    assert np.isfinite(float(m2["loss"]))
    assert float(m2["loss"]) < float(metrics["loss"]) + 0.5
