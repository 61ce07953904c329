"""The port's training stack against the reference: the trainer in AdamW
and signSGD mode, the bitmap-index data pipeline, checkpoints and the
straggler watchdog (the scenarios of ``tests/test_train_system.py``).

Both trainers start from the same parameters (the reference's, carried
over with ``params_from_reference``) and eat the same batches (each
package's own corpus; the tokens are asserted identical).  Tolerances:
AdamW losses rel 1e-4 and parameters atol 1e-4 after 3 steps (f32 math
summed in other orders, amplified by Adam's normalisation where the
second moment is tiny); signSGD's step-1 loss rel 1e-5; its packed sign
words of step 1 agree on at least 99.9% of bits, and a bit may differ
only where the reference's |acc| < 1e-6 (a gradient that close to 0 can
take either sign under another summation order); its losses over 3
steps rel 1e-3 (a flipped vote moves a weight by 2 lr).

The reference is imported only by the fixture that needs it, so the
``cuda`` case runs on a GPU machine without JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train.py``.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.bitops import to_uint32
from repro_torch.data.pipeline import BitmapIndex, SyntheticCorpus
from repro_torch.kernels.signcomp import (
    LANES,
    compress_signs,
    compress_signs_ref,
    decompress_signs,
    decompress_signs_ref,
)
from repro_torch.launch.train import main as train_main
from repro_torch.models.state import flatten, params_from_reference, params_to_reference
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import (
    OptimizerConfig,
    adamw_update,
    clip_by_global_norm,
    init_opt_state,
    signsgd_update,
)
from repro_torch.train.trainer import StragglerWatchdog, Trainer, TrainerConfig

STEPS = 3
BATCH, SEQ, SAMPLES = 4, 16, 512
# AdamW at the launcher's default lr: an element whose gradient changes
# sign between steps moves by up to ~lr, so parity error scales with it
ADAMW = ("granite-8b", OptimizerConfig(lr=1e-3), "none")
SIGNSGD = ("starcoder2-3b", OptimizerConfig(lr=1e-2, mode="signsgd"), "signsgd")


def _cfg(arch):
    cfg = get_config(arch).reduced()
    return cfg.with_(n_layers=2) if arch == "granite-8b" else cfg


@pytest.fixture(scope="module")
def ref():
    """The reference trainers' runs, one per mode (the JAX compiles are
    the cost of this file, so each runs once)."""
    pytest.importorskip("jax")
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.data.pipeline import SyntheticCorpus as RefCorpus
    from repro.kernels.signcomp import compress_signs as ref_compress
    from repro.train.steps import make_loss_fn
    from repro.train.trainer import Trainer as RefTrainer
    from repro.train.trainer import TrainerConfig as RefTrainerConfig

    out = {}
    for arch, opt, mode in (ADAMW, SIGNSGD):
        cfg = ref_get_config(arch).reduced()
        cfg = cfg.with_(n_layers=2) if arch == "granite-8b" else cfg
        tr = RefTrainer(cfg, RefTrainerConfig(opt=opt, compress_grads=mode))
        init = jax.tree.map(np.asarray, tr.params)
        corpus = RefCorpus(vocab=cfg.vocab, seq_len=SEQ, num_samples=SAMPLES)
        batches = [b for _, b in zip(range(STEPS), corpus.batches(BATCH))]
        run = SimpleNamespace(init=init, batches=batches, corpus=corpus)
        if mode == "signsgd":  # step 1's packed words: ef is 0, so acc = g
            _, g = jax.value_and_grad(make_loss_fn(cfg))(tr.params, batches[0])
            run.acc = {k: np.asarray(v, np.float32) for k, v in flatten(g).items()}
            run.words = {
                k: np.asarray(ref_compress(v.reshape(-1))) for k, v in flatten(g).items()
            }
        run.losses = tr.train(iter(batches), num_steps=STEPS, log_every=0)
        run.params = {k: np.asarray(v) for k, v in flatten(tr.params).items()}
        out[mode] = run
    return out


def _port_trainer(ref_run, arch, opt, mode, device="cpu"):
    tr = Trainer(_cfg(arch), TrainerConfig(opt=opt, compress_grads=mode), device=device)
    tr.params = params_from_reference(ref_run.init, device=device)
    return tr


def _port_batches(arch, device="cpu"):
    corpus = SyntheticCorpus(
        vocab=_cfg(arch).vocab, seq_len=SEQ, num_samples=SAMPLES, device=device
    )
    return [b for _, b in zip(range(STEPS), corpus.batches(BATCH))]


def test_adamw_trainer_matches_reference(ref):
    r = ref["none"]
    tr = _port_trainer(r, *ADAMW)
    losses = tr.train(iter(_port_batches(ADAMW[0])), num_steps=STEPS, log_every=0)
    np.testing.assert_allclose(losses, r.losses, rtol=1e-4)
    got = flatten(tr.params)
    for k, v in r.params.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v, rtol=0, atol=1e-4, err_msg=k)
    assert tr.opt_state["step"] == STEPS


def test_signsgd_trainer_matches_reference(ref):
    r = ref["signsgd"]
    tr = _port_trainer(r, *SIGNSGD)
    words = {}

    def hook(name, acc, w, signs):
        if tr.step_num == 0:
            words[name] = to_uint32(w)

    tr.leaf_hook = hook
    losses = tr.train(iter(_port_batches(SIGNSGD[0])), num_steps=STEPS, log_every=0)
    assert losses[0] == pytest.approx(r.losses[0], rel=1e-5)
    np.testing.assert_allclose(losses, r.losses, rtol=1e-3)

    assert list(words) == list(r.words) and len(words) == 19
    total = differ = 0
    for k, want in r.words.items():
        got = words[k]
        assert got.shape == want.shape, k
        bits = np.unpackbits((got ^ want).view(np.uint8), bitorder="little")
        # element e of the flat leaf is bit b of word (r, c): e = (32 r + b) W + c
        R, W = want.shape
        flips = bits.reshape(R, W, 32).transpose(0, 2, 1).reshape(-1)
        acc = r.acc[k].reshape(-1)
        where = np.nonzero(flips[: acc.size])[0]
        assert np.all(np.abs(acc[where]) < 1e-6), (k, acc[where][:5])
        assert not flips[acc.size :].any()  # the padding packs to 1 in both
        total += acc.size
        differ += where.size
    assert differ <= 1e-3 * total


@pytest.mark.parametrize("mode", ["adamw", "signsgd"])
def test_optimizer_update_matches_reference(ref, mode):
    """One update of a two-leaf tree, from moments left by an earlier
    step: f32 math in the same order, so 1e-6 relative."""
    import jax.numpy as jnp

    from repro.train import optimizer as ref_opt

    rng = np.random.default_rng(9)
    tree = {"a": rng.normal(size=(3, 5)), "b": {"c": rng.normal(size=(7,))}}
    p, g, mu, nu = (
        {k: v.astype(np.float32) for k, v in flatten(tree).items()} for tree in
        ({"a": rng.normal(size=(3, 5)), "b/c": rng.normal(size=(7,))} for _ in range(4))
    )
    nu = {k: np.abs(v) for k, v in nu.items()}
    cfg = OptimizerConfig(lr=1e-2, mode=mode)
    ref_state = {"mu": jnp_tree(mu), "nu": jnp_tree(nu), "step": jnp.asarray(2, jnp.int32)}
    if mode == "adamw":
        clipped, gnorm = ref_opt.clip_by_global_norm(jnp_tree(g), 0.5)
        want, ref_state = ref_opt.adamw_update(jnp_tree(p), clipped, ref_state, cfg)
        grads, got_norm = clip_by_global_norm([torch.from_numpy(v.copy()) for v in g.values()], 0.5)
        assert float(got_norm) == pytest.approx(float(gnorm), rel=1e-6)
        state = {"mu": torch_tree(mu), "nu": torch_tree(nu), "step": 2}
        got, state = adamw_update(torch_tree(p), grads, state, cfg)
        for k, v in ref_state["mu"].items():
            np.testing.assert_allclose(state["mu"][k].numpy(), np.asarray(v), rtol=1e-6)
    else:
        want, ref_state = ref_opt.signsgd_update(jnp_tree(p), jnp_tree(g), ref_state, cfg)
        state = init_opt_state(torch_tree(p), cfg) | {"step": 2}
        got, state = signsgd_update(torch_tree(p), torch_tree(g), state, cfg)
    assert state["step"] == int(ref_state["step"]) == 3
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-6, atol=1e-7)


def jnp_tree(flat):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in flat.items()}


def torch_tree(flat):
    return {k: torch.from_numpy(v.copy()) for k, v in flat.items()}


def test_bitmap_index_and_batches_match_reference(ref):
    r = ref["none"]
    ri = r.corpus.index
    idx = SyntheticCorpus(vocab=256, seq_len=SEQ, num_samples=SAMPLES, device="cpu").index
    np.testing.assert_array_equal(to_uint32(idx.planes), np.asarray(ri.planes))
    for preds in (["lang_en"], ["lang_en", "quality_high"], ["lang_en", "quality_high", "not_toxic"]):
        assert idx.count(preds) == ri.count(preds)
        np.testing.assert_array_equal(idx.eligible_indices(preds), ri.eligible_indices(preds))
    for got, want in zip(_port_batches(ADAMW[0]), r.batches):
        assert got["inputs"]["tokens"].dtype == torch.int64
        np.testing.assert_array_equal(got["inputs"]["tokens"].numpy(), np.asarray(want["inputs"]["tokens"]))
        np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))


def test_bitmap_index_filtering_correctness():
    idx = BitmapIndex.synthesize(1000, seed=3, device="cpu")
    planes = np.unpackbits(to_uint32(idx.planes).view(np.uint8), axis=1, bitorder="little")
    planes = planes[:, : idx.num_samples]
    pick = [idx.names.index(p) for p in ("lang_en", "quality_high", "not_toxic")]
    want = np.nonzero(planes[pick[0]] & planes[pick[1]] & planes[pick[2]])[0]
    np.testing.assert_array_equal(
        idx.eligible_indices(["lang_en", "quality_high", "not_toxic"]), want
    )
    assert idx.count(["lang_en"]) == int(planes[idx.names.index("lang_en")].sum())


@pytest.mark.parametrize(
    "arch,opt,mode,drop",
    [("granite-8b", OptimizerConfig(lr=1e-2), "none", 1.0), SIGNSGD + (0.3,)],
)
def test_training_loss_decreases(arch, opt, mode, drop):
    """Overfit one repeated batch: the loss must drop markedly."""
    tr = Trainer(_cfg(arch), TrainerConfig(opt=opt, compress_grads=mode), device="cpu")
    batch = _port_batches(arch)[0]
    hist = tr.train(iter(lambda: batch, None), num_steps=30, log_every=0)
    assert hist[-1] < hist[0] - drop, (hist[0], hist[-1])


@pytest.mark.parametrize("mode", ["none", "signsgd"])
def test_checkpoint_restart_resumes(tmp_path, mode):
    arch = "granite-8b"
    tcfg = TrainerConfig(
        opt=OptimizerConfig(lr=1e-3, mode="signsgd" if mode == "signsgd" else "adamw"),
        ckpt_dir=str(tmp_path),
        ckpt_every=5,
        compress_grads=mode,
    )
    batch = _port_batches(arch)[0]
    tr = Trainer(_cfg(arch), tcfg, device="cpu")
    tr.train(iter(lambda: batch, None), num_steps=10, log_every=0)
    want = {k: v.detach().clone() for k, v in flatten(tr.params).items()}

    tr2 = Trainer(_cfg(arch), tcfg, device="cpu", rng_seed=1)  # a new process
    assert tr2.maybe_restore()
    assert tr2.step_num == 10 and tr2.opt_state["step"] == 10
    for k, v in flatten(tr2.params).items():
        assert torch.equal(v, want[k]), k
    hist = tr2.train(iter(lambda: batch, None), num_steps=3, log_every=0)
    assert np.isfinite(hist[-1]) and tr2.step_num == 13


def test_checkpoint_atomicity_keeps_complete_only(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(8.0), "step": 4}
    for s in (1, 2, 3):
        m.save(s, tree, block=s != 3)
    m.wait()
    assert m.steps() == [2, 3]  # keep=2 collected step_1
    os.makedirs(os.path.join(str(tmp_path), "step_9.tmp-abc"))  # a crashed write
    assert 9 not in m.steps() and m.latest_step() == 3
    back = m.restore({"w": torch.zeros(8), "step": 0})
    assert torch.equal(back["w"], tree["w"]) and back["step"] == 4


def test_checkpoint_keeps_bf16_bits(tmp_path):
    m = CheckpointManager(str(tmp_path))
    w = torch.randn(5, 7).to(torch.bfloat16)
    m.save(1, {"w": w})
    back = m.restore({"w": torch.zeros(5, 7, dtype=torch.bfloat16)})["w"]
    assert back.dtype == torch.bfloat16 and torch.equal(back.view(torch.int16), w.view(torch.int16))


def test_straggler_watchdog_detects():
    events = []
    wd = StragglerWatchdog(factor=2.0, warmup=2, on_straggler=lambda s, dt, e: events.append(s))
    for i in range(10):
        wd.observe(i, 0.1)
    wd.observe(10, 0.5)  # 5x the EWMA -> straggler
    assert events == [10]
    wd.observe(11, 0.1)  # recovery: no event
    assert events == [10]


def test_launcher_trains_on_the_cpu(capsys):
    hist = train_main(
        ["--arch", "granite-8b", "--reduced", "--device", "cpu", "--steps", "5", "--signsgd"]
    )
    assert len(hist) == 5 and all(np.isfinite(hist))
    assert "final loss" in capsys.readouterr().out


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_cfg("granite-8b"), TrainerConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticCorpus(vocab=256, seq_len=8)


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_signsgd_on_the_card_matches_the_cpu(cuda):
    """The same signSGD run on the card (kernels B1, B2, B5, B6) and on the
    CPU (their plain versions), from the same parameters: every pack and
    unpack launches once per leaf per step, the words of step 1 agree
    bit for bit except where |acc| < 1e-6, and the losses within rel 1e-3
    (f32 matmuls in full f32: TF32 is off by default)."""
    arch, opt, mode = SIGNSGD
    init = Trainer(_cfg(arch), TrainerConfig(opt=opt, compress_grads=mode), device="cpu")
    runs = {}
    for device in ("cpu", cuda):
        tr = Trainer(_cfg(arch), TrainerConfig(opt=opt, compress_grads=mode), device=device)
        tr.params = params_from_reference(params_to_reference(init.params), device=device)
        accs = {}

        def hook(name, acc, w, signs, tr=tr, accs=accs):
            if tr.step_num == 0:  # the plain versions launch nothing
                flat = acc.reshape(-1)
                assert torch.equal(w, compress_signs_ref(flat, LANES))
                assert torch.equal(signs, decompress_signs_ref(w, flat.numel()))
                accs[name] = (flat.cpu().numpy(), to_uint32(w))

        tr.leaf_hook = hook
        counts = (compress_signs.launches, decompress_signs.launches)
        losses = tr.train(iter(_port_batches(arch, device)), num_steps=STEPS, log_every=0)
        runs[str(device)] = (losses, accs, compress_signs.launches - counts[0],
                             decompress_signs.launches - counts[1])
    (l_cpu, a_cpu, *_), (l_gpu, a_gpu, n_pack, n_unpack) = runs["cpu"], runs[str(cuda)]
    assert n_pack == n_unpack == 19 * STEPS
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-3)
    for k, (acc, w) in a_cpu.items():
        flips = np.unpackbits((w ^ a_gpu[k][1]).view(np.uint8), bitorder="little")
        R, W = w.shape
        flips = flips.reshape(R, W, 32).transpose(0, 2, 1).reshape(-1)[: acc.size]
        assert np.all(np.abs(acc[np.nonzero(flips)[0]]) < 1e-6), k


@pytest.mark.cuda
def test_one_rank_nccl_mesh_trainer_matches_the_unsharded_trainer(cuda, tmp_path):
    """The signSGD trainer on a one-rank NCCL ("data", "model") mesh and
    without one, from the same parameters, on the card: a one-rank
    collective is a copy, so losses and parameters agree to 1e-6 and B5/B6
    launch once per leaf per step on the sharded run too."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import is_dtensor, shard_tree
    from repro_torch.launch.mesh import init_process_group, make_host_mesh

    arch, opt, mode = SIGNSGD
    init = Trainer(_cfg(arch), TrainerConfig(opt=opt, compress_grads=mode), device="cpu")
    init_process_group("cuda", init_method=f"file://{tmp_path}/pg")
    try:
        mesh = make_host_mesh(1, 1, device_type="cuda")
        runs = {}
        for label, m in (("plain", None), ("mesh", mesh)):
            tr = Trainer(_cfg(arch), TrainerConfig(opt=opt, compress_grads=mode), device=cuda, mesh=m)
            params = params_from_reference(params_to_reference(init.params), device=cuda)
            tr.params = shard_tree(params, tr.param_specs, m) if m is not None else params
            counts = compress_signs.launches
            losses = tr.train(iter(_port_batches(arch, cuda)), num_steps=STEPS, log_every=0)
            final = {
                k: (v.full_tensor() if is_dtensor(v) else v).detach().cpu().numpy()
                for k, v in flatten(tr.params).items()
            }
            runs[label] = (losses, final, compress_signs.launches - counts)
    finally:
        dist.destroy_process_group()
    (l_plain, p_plain, n_plain), (l_mesh, p_mesh, n_mesh) = runs["plain"], runs["mesh"]
    assert n_plain == n_mesh == 19 * STEPS
    np.testing.assert_allclose(l_mesh, l_plain, rtol=1e-6)
    for k, v in p_plain.items():
        np.testing.assert_allclose(p_mesh[k], v, rtol=0, atol=1e-6, err_msg=k)

