"""The port's MoE decoder (``models/moe.py``) against the reference.

Reduced deepseek-v2-lite-16b (MLA, one dense layer, shared experts) and
kimi-k2-1t-a32b (GQA), f32 on the CPU.  Parameters are drawn once (the
port's seeded init, as numpy) and carried across; tokens come from a
numpy seed.  The forward is held to the reference's under both dispatch
modes at the reduced capacity (C = S: nothing drops) and at capacity
factor 0.5, where assignments drop into the scratch slot: logits rtol/atol
1e-4.  The two modes against each other: atol 1e-6 and, for gradients,
rtol 2e-4 / atol 2e-5, as ``tests/test_perf_variants.py`` holds the
reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import moe as M
from repro_torch.models.state import flatten, params_from_reference, params_to_reference
from repro_torch.train.steps import loss_and_grads, make_loss_fn

ARCHS = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]
CAPACITY = {"reduced": None, "drops": 0.5}
B, S = 2, 16


def _cfg(arch, capacity="reduced", dispatch="scatter", base=None):
    cfg = (base or get_config)(arch).reduced().with_(moe_dispatch=dispatch)
    if CAPACITY[capacity] is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=CAPACITY[capacity]))
    return cfg


def _case(arch):
    seed = ARCHS.index(arch)
    params = params_to_reference(M.init_params(_cfg(arch), seed, "cpu"))
    tokens = np.random.default_rng(20 + seed).integers(0, 256, (B, S + 1))
    return params, tokens


@pytest.mark.parametrize("dispatch", ["scatter", "gather"])
@pytest.mark.parametrize("capacity", CAPACITY)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, capacity, dispatch):
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.models import moe as ref_moe

    params, tokens = _case(arch)
    ref_cfg = _cfg(arch, capacity, dispatch, base=ref_get_config)
    want = jax.jit(lambda p, t: ref_moe.forward(ref_cfg, p, t))(
        params, jnp.asarray(tokens[:, :-1], jnp.int32)
    )
    cfg = _cfg(arch, capacity, dispatch)
    with torch.no_grad():
        got = M.forward(cfg, params_from_reference(params, "cpu"), torch.from_numpy(tokens[:, :-1]))
    assert got.shape == (B, S, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("capacity", CAPACITY)
@pytest.mark.parametrize("arch", ARCHS)
def test_gather_dispatch_matches_scatter(arch, capacity):
    params, tokens = _case(arch)
    params = params_from_reference(params, "cpu")
    toks = torch.from_numpy(tokens[:, :-1])
    with torch.no_grad():
        ref = M.forward(_cfg(arch, capacity), params, toks)
        got = M.forward(_cfg(arch, capacity, "gather"), params, toks)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_low_capacity_drops_assignments(arch):
    """At capacity factor 0.5 some assignments drop (the scratch slot is
    exercised), so the output differs from the no-drop forward."""
    params, tokens = _case(arch)
    params = params_from_reference(params, "cpu")
    toks = torch.from_numpy(tokens[:, :-1])
    with torch.no_grad():
        full = M.forward(_cfg(arch), params, toks)
        dropped = M.forward(_cfg(arch, "drops"), params, toks)
    assert not torch.allclose(full, dropped, atol=1e-3)


def test_gather_dispatch_matches_scatter_grads():
    params, tokens = _case("deepseek-v2-lite-16b")
    toks = torch.from_numpy(tokens)
    batch = {"inputs": {"tokens": toks[:, :-1]}, "labels": toks[:, 1:]}
    grads = {}
    for dispatch in ("scatter", "gather"):
        cfg = _cfg("deepseek-v2-lite-16b", dispatch=dispatch)
        _, grads[dispatch] = loss_and_grads(
            make_loss_fn(cfg), params_from_reference(params, "cpu"), batch
        )
    for a, b in zip(grads["scatter"], grads["gather"]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_leaves_line_up_with_the_reference(arch):
    """The port's tree has the reference's leaves, shapes and dtypes (bf16
    parameters, an f32 router; one dense layer stacked with a leading 1),
    and a reference tree crosses into the port and back leaf for leaf."""
    pytest.importorskip("jax")
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.models import moe as ref_moe

    ref_cfg = ref_get_config(arch).reduced().with_(param_dtype="bfloat16")
    init = jax.jit(lambda k: ref_moe.init_params(ref_cfg, k)[0])
    want = flatten(jax.eval_shape(init, jax.random.PRNGKey(0)))
    cfg = get_config(arch).reduced().with_(param_dtype="bfloat16")
    got = flatten(M.init_params(cfg, 0, "cpu"))
    assert list(got) == list(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape and str(got[k].dtype) == f"torch.{v.dtype}", k
    assert got["layers/ffn/router"].dtype == torch.float32
    assert got["dense_layers/ffn/up"].shape[0] == 1
    real = jax.tree.map(np.asarray, init(jax.random.PRNGKey(1)))
    back = flatten(params_to_reference(params_from_reference(real, "cpu")))
    for k, v in flatten(real).items():
        np.testing.assert_array_equal(back[k], v.astype(np.float32), err_msg=k)
