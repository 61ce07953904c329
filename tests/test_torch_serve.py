"""LM serving in the port against the reference: attention with a KV cache,
prefill and decode for the dense, VLM and MoE families, ``demo_batch``,
``serve`` and its launcher for every family, and the cache's in-place
contract.  The recurrent and encoder-decoder families' prefill and
decode are held to the reference in ``tests/test_torch_{xlstm,rglru,encdec}.py``.

Both packages get identical inputs: parameters drawn once (the port's
seeded init, as numpy) and carried into the port with
``params_from_reference``; tokens and patch embeddings from a numpy seed.
Tolerances (f32 on the CPU): attention rtol/atol 1e-5, logits and caches
1e-4, the same math summed in other orders.  A decode step against the
port's own full forward: 3e-3, as ``tests/test_arch_smoke.py`` holds the
reference.  JAX is imported inside fixtures and tests only, so the
``cuda`` cases run on a machine without it.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve
from repro_torch.launch.specs import demo_batch
from repro_torch.models import layers as L
from repro_torch.models.registry import get_model
from repro_torch.models.state import params_from_reference, params_to_reference

ARCHS = ["granite-8b", "starcoder2-3b", "internvl2-26b", "deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]
RECURRENT_AND_AUDIO = ["xlstm-350m", "recurrentgemma-2b", "whisper-medium"]
B, S, STEPS = 2, 9, 3


def _cfg(arch):
    return get_config(arch).reduced()


def _np_params(cfg, seed=0):
    return params_to_reference(get_model(cfg).init_params(cfg, seed, "cpu"))


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S))
    extra = {}
    if cfg.family == "audio":  # more frames than tokens
        extra["frames"] = rng.normal(size=(B, S + 5, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        patches = rng.normal(size=(B, cfg.num_patch_tokens, cfg.d_model))
        extra["patch_embeds"] = patches.astype(np.float32)
    return tokens, extra


def _torch(extra, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in extra.items()}


@pytest.fixture(scope="module")
def ref_serving():
    """Per arch: the reference's prefill and STEPS greedy decode steps
    (logits, cache after each call, the ids it chose), jitted once."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.models.registry import get_model as ref_get_model

    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = ref_get_config(arch).reduced()
        model = ref_get_model(cfg)
        params = _np_params(_cfg(arch), seed=i)
        tokens, extra = _inputs(cfg, seed=10 + i)
        n_ctx = S + cfg.num_patch_tokens
        max_len = n_ctx + STEPS + 1
        pf = jax.jit(lambda p, t, e, c=cfg, m=model, n=max_len: m.prefill(c, p, t, max_len=n, **e))
        dc = jax.jit(lambda p, k, t, o, c=cfg, m=model: m.decode_step(c, p, k, t, o))
        logits, cache = pf(params, jnp.asarray(tokens, jnp.int32), extra)
        logs, caches, ids = [], [], []
        for step in range(STEPS + 1):
            if step:
                logits, cache = dc(params, cache, ids[-1], jnp.int32(n_ctx + step - 1))
            logs.append(np.asarray(logits))
            caches.append({k: np.asarray(v) for k, v in cache.items()})
            ids.append(jnp.argmax(logits[:, -1:], -1).astype(jnp.int32))
        out[arch] = SimpleNamespace(
            params=params,
            tokens=tokens,
            extra=extra,
            n_ctx=n_ctx,
            max_len=max_len,
            logits=logs,
            caches=caches,
            ids=np.concatenate([np.asarray(t) for t in ids], axis=1).astype(np.int64),
        )
    return out


@pytest.fixture(scope="module")
def port_serving(ref_serving):
    """The port's prefill and decode steps on the same parameters, fed the
    reference's chosen ids (so one near-tie cannot fork the runs)."""
    out = {}
    for arch, r in ref_serving.items():
        cfg = _cfg(arch)
        model = get_model(cfg)
        params = params_from_reference(r.params, device="cpu")
        logits, cache = model.prefill(
            cfg, params, torch.from_numpy(r.tokens), max_len=r.max_len, **_torch(r.extra)
        )
        logs = [logits.numpy()]
        caches = [{k: v.clone().numpy() for k, v in cache.items()}]
        for step in range(1, STEPS + 1):
            nxt = torch.from_numpy(r.ids[:, step - 1 : step])
            logits, cache = model.decode_step(cfg, params, cache, nxt, r.n_ctx + step - 1)
            logs.append(logits.numpy())
            caches.append({k: v.clone().numpy() for k, v in cache.items()})
        out[arch] = SimpleNamespace(cfg=cfg, params=params, logits=logs, caches=caches)
    return out


# -- attention_fwd -------------------------------------------------------------

H, KV, HD, S_MAX = 4, 2, 8, 26
ATTN_CASES = {
    "prefill": dict(s=9, offset=0),
    "decode": dict(s=1, offset=13),
    "chunk_window3": dict(s=5, offset=6, window=3),
    "decode_window3": dict(s=1, offset=20, window=3),
    "positions": dict(s=7, positions=True, cache=False),
    "window3_no_cache": dict(s=11, window=3, cache=False),
    "cross": dict(s=6, kv_len=10, cross=True, causal=False, cache=False),
    "cross_cached": dict(s=3, kv_len=10, cross=True, offset=4),
}


def _attn_inputs(case, seed):
    rng = np.random.default_rng(seed)
    d = H * HD
    p = {k: rng.normal(size=(d, n * HD)) / 6 for k, n in (("wq", H), ("wk", KV), ("wv", KV))}
    p["wo"] = rng.normal(size=(d, d)) / 6
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(B, case["s"], d)).astype(np.float32)
    kw = dict(n_heads=H, n_kv_heads=KV, window=case.get("window"), causal=case.get("causal", True))
    arrays = {}
    if case.get("cross"):
        arrays["kv_x"] = rng.normal(size=(B, case["kv_len"], d)).astype(np.float32)
    if case.get("positions"):
        arrays["positions"] = rng.integers(0, 50, (B, case["s"]))
    cache = None
    if case.get("cache", True):  # earlier steps' entries, and stale ones past them
        cache = tuple(rng.normal(size=(B, S_MAX, KV, HD)).astype(np.float32) for _ in range(2))
        kw["cache_offset"] = case["offset"]
    return p, x, kw, arrays, cache


@pytest.mark.parametrize("impl", ["naive", "blockwise"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_matches_reference(monkeypatch, case, impl):
    """The output, and the cache written in place, equal the reference's
    (blocks of 8 over a 26-slot cache: several blocks and a ragged one)."""
    import jax.numpy as jnp
    from repro.models import layers as ref_layers

    monkeypatch.setattr(L, "BLOCKWISE_KV_BLOCK", 8)
    monkeypatch.setattr(ref_layers, "BLOCKWISE_KV_BLOCK", 8)
    p, x, kw, arrays, cache = _attn_inputs(ATTN_CASES[case], seed=len(case))
    ref_kw = dict(kw, **{k: jnp.asarray(v) for k, v in arrays.items()})
    port_kw = dict(kw, **{k: torch.from_numpy(v) for k, v in arrays.items()})
    if cache is not None:
        ref_kw["kv_cache"] = tuple(jnp.asarray(c) for c in cache)
        port_cache = tuple(torch.from_numpy(c.copy()) for c in cache)
        port_kw["kv_cache"] = port_cache
    want, want_cache = ref_layers.attention_fwd(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), impl=impl, **ref_kw
    )
    got = L.attention_fwd(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), impl=impl, **port_kw
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if cache is not None:
        for g, w in zip(port_cache, want_cache):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_auto_attention_takes_the_blockwise_path_over_a_long_cache(monkeypatch):
    """Under "auto" the switch reads the cache's length: a one-token decode
    step over a cache of BLOCKWISE_MIN_KV slots runs blockwise at its
    large offset (the reference's rule, ``layers.py:164-165``)."""
    calls = []
    real = L._blockwise_attention
    monkeypatch.setattr(
        L, "_blockwise_attention", lambda *a, **k: calls.append(k["offset"]) or real(*a, **k)
    )
    monkeypatch.setattr(L, "BLOCKWISE_MIN_KV", 16)
    p, x, kw, _, cache = _attn_inputs(ATTN_CASES["decode"], seed=3)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for s_max, want in ((15, []), (16, [13])):
        c = tuple(torch.from_numpy(a[:, :s_max].copy()) for a in cache)
        L.attention_fwd(tp, torch.from_numpy(x), kv_cache=c, impl="auto", **kw)
        assert calls == want


def test_cache_writes_in_place_and_past_the_end_raises():
    """C11: the port's decode step writes into the cache it is given and
    returns the same dict of the same tensors.  C12: the reference's
    ``dynamic_update_slice`` clamps a write past the end onto the last
    slots; the port raises instead."""
    import jax.numpy as jnp
    from repro.models import layers as ref_layers

    cfg = _cfg("granite-8b")
    model = get_model(cfg)
    params = model.init_params(cfg, 0, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (B, S)))
    _, cache = model.prefill(cfg, params, tokens, max_len=S + 2)
    k_before = cache["k"].clone()
    tensors = dict(cache)
    _, out = model.decode_step(cfg, params, cache, tokens[:, :1], S)
    assert out is cache and all(out[k] is tensors[k] for k in tensors)
    assert torch.equal(cache["k"][:, :, :S], k_before[:, :, :S])
    assert not torch.equal(cache["k"][:, :, S], k_before[:, :, S])
    with pytest.raises(ValueError, match="outside a cache"):
        model.decode_step(cfg, params, cache, tokens[:, :1], S + 2)
    with pytest.raises(TypeError, match="host int"):
        model.decode_step(cfg, params, cache, tokens[:, :1], torch.tensor(S))

    p, x, kw, _, cache_np = _attn_inputs(dict(s=2, offset=0), seed=4)
    kw["cache_offset"] = S_MAX - 1  # the write needs slots 25 and 26 of 26
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    _, (ref_k, _) = ref_layers.attention_fwd(
        jp, jnp.asarray(x), kv_cache=tuple(jnp.asarray(c) for c in cache_np), **kw
    )
    changed = np.nonzero(np.any(np.asarray(ref_k) != cache_np[0], axis=(0, 2, 3)))[0]
    assert changed.tolist() == [S_MAX - 2, S_MAX - 1]  # clamped to start at 24
    port_cache = tuple(torch.from_numpy(c.copy()) for c in cache_np)
    with pytest.raises(ValueError, match="outside a cache"):
        L.attention_fwd(
            {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(x),
            kv_cache=port_cache,
            **kw,
        )
    assert torch.equal(port_cache[0], torch.from_numpy(cache_np[0]))


# -- prefill and decode against the reference ------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(ref_serving, port_serving, arch):
    r, g = ref_serving[arch], port_serving[arch]
    assert g.logits[0].shape == r.logits[0].shape == (B, 1, g.cfg.vocab)
    np.testing.assert_allclose(g.logits[0], r.logits[0], rtol=1e-4, atol=1e-4)
    assert sorted(g.caches[0]) == sorted(r.caches[0])
    for k, want in r.caches[0].items():
        np.testing.assert_allclose(g.caches[0][k], want, rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(ref_serving, port_serving, arch):
    r, g = ref_serving[arch], port_serving[arch]
    for step in range(1, STEPS + 1):
        np.testing.assert_allclose(
            g.logits[step], r.logits[step], rtol=1e-4, atol=1e-4, err_msg=f"step {step}"
        )
        for k, want in r.caches[step].items():
            np.testing.assert_allclose(
                g.caches[step][k], want, rtol=1e-4, atol=1e-4, err_msg=f"step {step} {k}"
            )


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_gives_the_reference_greedy_ids(ref_serving, port_serving, arch):
    r, g = ref_serving[arch], port_serving[arch]
    ids = serve(g.cfg, g.params, torch.from_numpy(r.tokens), STEPS + 1, _torch(r.extra), "cpu")
    assert ids.dtype == torch.int64
    np.testing.assert_array_equal(ids.numpy(), r.ids)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_own_forward(arch):
    """Prefill's last logits and a decode step's equal the port's full
    forward over the same tokens (``tests/test_arch_smoke.py:57``)."""
    cfg = _cfg(arch)
    model = get_model(cfg)
    params = model.init_params(cfg, 7, "cpu")
    tokens, extra = _inputs(cfg, seed=3)
    tokens, extra = torch.from_numpy(tokens), _torch(extra)
    n_ctx = S + cfg.num_patch_tokens
    with torch.no_grad():
        full = model.forward(cfg, params, tokens, **extra)
    assert full.shape == (B, S, cfg.vocab)
    pl, cache = model.prefill(cfg, params, tokens, **extra, max_len=n_ctx + 4)
    np.testing.assert_allclose(pl[:, -1].numpy(), full[:, -1].numpy(), rtol=3e-3, atol=3e-3)
    nxt = torch.argmax(pl[:, -1:], -1)
    dl, _ = model.decode_step(cfg, params, cache, nxt, n_ctx)
    with torch.no_grad():
        full2 = model.forward(cfg, params, torch.cat([tokens, nxt], 1), **extra)
    np.testing.assert_allclose(dl[:, -1].numpy(), full2[:, -1].numpy(), rtol=3e-3, atol=3e-3)


# -- demo_batch, the launcher ---------------------------------------------------------


@pytest.mark.parametrize(
    "arch,dtype",
    [("granite-8b", "float32"), ("internvl2-26b", "float32"), ("internvl2-26b", "bfloat16"),
     ("whisper-medium", "bfloat16")],
)
def test_demo_batch_is_the_references(arch, dtype):
    pytest.importorskip("jax")
    from repro.configs import get_config as ref_get_config
    from repro.launch.specs import demo_batch as ref_demo_batch

    want = ref_demo_batch(ref_get_config(arch).reduced().with_(compute_dtype=dtype), 2, 8, seed=5)
    got = demo_batch(_cfg(arch).with_(compute_dtype=dtype), 2, 8, seed=5, device="cpu")
    assert sorted(got["inputs"]) == sorted(want["inputs"])
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    for k, w in want["inputs"].items():
        g = got["inputs"][k]
        assert str(g.dtype) == ("torch.int64" if k == "tokens" else f"torch.{dtype}")
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w).astype(np.float32), err_msg=k)


@pytest.mark.parametrize(
    "arch", ["granite-8b", "internvl2-26b", "deepseek-v2-lite-16b", *RECURRENT_AND_AUDIO]
)
def test_launcher_serves_on_the_cpu(capsys, arch):
    ids = serve_main(["--arch", arch, "--reduced", "--device", "cpu", "--tokens", "4"])
    assert ids.shape == (2, 4)
    out = capsys.readouterr().out
    assert "prefill 32 tokens" in out and "decoded 4 tokens x2" in out and "sample:" in out


def test_serving_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main(["--arch", "granite-8b", "--reduced"])
    cfg = _cfg("granite-8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(cfg, None, torch.zeros((1, 4), dtype=torch.int64), 2)


# -- chip_smoke.py's serving phase, rehearsed on the CPU --------------------------


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REHEARSALS = {  # arch: (prompt, frames)
    "granite-8b": (12, 0),
    "deepseek-v2-lite-16b": (12, 0),
    "xlstm-350m": (130, 0),  # a chunk and a ragged tail
    "recurrentgemma-2b": (20, 0),  # the ring (window 16) full, then overwritten
    "whisper-medium": (12, 30),  # more frames than tokens
}


@pytest.mark.parametrize("arch", REHEARSALS)
def test_smoke_serve_path_rehearsal(arch):
    """``serve_path`` at a reduced config on the CPU: its checks (prefill
    and the first decode steps against the full forward) pass, and it
    reports its metrics (times are the CPU's and carry no device name)."""
    smoke = _chip_smoke()
    prompt, frames = REHEARSALS[arch]
    out = smoke.serve_path(
        "cpu", _cfg(arch), batch=2, prompt=prompt, tokens=6, frames=frames, log=lambda m: None
    )
    assert out["arch"] == _cfg(arch).name and out["tokens_generated"] == 2 * 6
    assert out["context"] == prompt and out["frames"] == frames
    assert len(out["check"]["decode_vs_forward"]) == 1 + smoke.SERVE_CHECK_STEPS
    assert out["check"]["worst"] <= out["check"]["tol"] == smoke.SERVE_F32_RATIO_TOL
    assert out["decode_bound_bytes"] > 0 and "device_idle_share" not in out


# -- the card (d): reduced configs, f32, served on the card equal the CPU -----------


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "arch", ["granite-8b", "internvl2-26b", "deepseek-v2-lite-16b", *RECURRENT_AND_AUDIO]
)
def test_reduced_serving_on_the_card_matches_the_cpu(cuda, arch):
    """The same params and prompts served in f32 on the card and on the
    CPU: logits within 1e-4, greedy ids equal.  f32 matmuls stay in full
    f32 on the card (TF32 off, torch's default)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = _cfg(arch)
    params = get_model(cfg).init_params(cfg, 0, "cpu")
    tokens, extra = _inputs(cfg, seed=2)
    runs = {}
    for device in ("cpu", cuda):
        logs = []
        ids = serve(
            cfg,
            params_from_reference(params_to_reference(params), device=device),
            torch.from_numpy(tokens),
            6,
            _torch(extra),
            device,
            on_step=lambda i, lg, logs=logs: logs.append(lg.cpu().numpy()),
        )
        runs[str(device)] = (ids.cpu().numpy(), logs)
    (ids_cpu, l_cpu), (ids_gpu, l_gpu) = runs["cpu"], runs[str(cuda)]
    for a, b in zip(l_gpu, l_cpu):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ids_gpu, ids_cpu)
