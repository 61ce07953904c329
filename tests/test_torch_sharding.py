"""The port's logical-axis sharding against the reference.

* The spec trees: every arch's ``param_specs`` / ``kv_cache_specs`` equal
  the reference's ``init_params`` / ``init_kv_cache`` spec trees leaf for
  leaf (taken through ``jax.eval_shape``).
* ``resolve_spec`` equals the reference's on 1x1, 2x2, 16x16 and 2x16x16
  meshes.
* One 4-rank gloo job on a 2x2 ("data", "model") mesh
  (``tests/_dist_worker.py``, spawned once for this file), started from
  the reference's parameters: the losses of one arch per family
  (granite-8b (2 layers), starcoder2-3b, deepseek-v2-lite-16b,
  recurrentgemma-2b, xlstm-350m, whisper-medium) within 1e-4 of the
  reference's single-device loss, and every gradient leaf of each within
  rtol 2e-3, atol 2e-4 (the reference's own tolerances,
  ``tests/test_distributed.py:67,99``); one signSGD step (starcoder2-3b)
  and one AdamW step (granite-8b) against the unsharded port's step, the
  gathered ``acc`` and updated parameters within the gradient tolerance
  and the signs equal to the sign rule of the gathered ``acc`` exactly;
  and a checkpoint saved on the 2x2 mesh restored onto a 1x2 mesh and onto
  no mesh with the same values.

The reference needs one device: its own tests hold sharded == single
device (``tests/test_distributed.py:42-102``).
"""

import pickle

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.sharding import (
    P,
    AbstractMesh,
    placements,
    resolve_spec,
    resolve_tree,
)
from repro_torch.models.registry import get_model

import _dist_worker

GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
BATCH, SEQ = 4, 16
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
# activation specs the models constrain to, beside every parameter spec
ACTIVATION_SPECS = [
    P("data", None, None),
    P("data", None, "model"),
    P("data", "model", None, None),
    P(None, "data"),
    P(("fsdp", "model"), None),
    P(("data", "pod"), "model"),
    P(),
]


def _plain(tree):
    """A spec tree as nested dicts/lists with each spec a tuple, for either
    package's spec type."""
    from jax.sharding import PartitionSpec

    if isinstance(tree, (PartitionSpec, P)):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    raise TypeError(type(tree))


def _ref_specs(arch):
    """The reference's parameter and cache spec trees of the reduced config."""
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.models.registry import get_model as ref_get_model

    cfg = ref_get_config(arch).reduced()
    model = ref_get_model(cfg)
    box = {}

    def init():
        p, box["params"] = model.init_params(cfg, jax.random.PRNGKey(0))
        return p

    def cache():
        kw = {"enc_len": 1} if cfg.family == "audio" else {}
        c, box["cache"] = model.init_kv_cache(cfg, 1, 1, **kw)
        return c

    jax.eval_shape(init)
    jax.eval_shape(cache)
    return box["params"], box["cache"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_equal_the_reference(arch):
    pytest.importorskip("jax")
    ref_params, ref_cache = _ref_specs(arch)
    cfg = get_config(arch).reduced()
    model = get_model(cfg)
    assert _plain(model.param_specs(cfg)) == _plain(ref_params)
    assert _plain(model.kv_cache_specs(cfg)) == _plain(ref_cache)
    from jax.sharding import AbstractMesh as RefAbstractMesh

    from repro.distributed.sharding import resolve_tree as ref_resolve_tree

    shape, axes = MESHES["2x16x16"]
    got = resolve_tree(model.param_specs(cfg), AbstractMesh(shape, axes))
    assert _plain(got) == _plain(ref_resolve_tree(ref_params, RefAbstractMesh(shape, axes)))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_resolve_spec_equals_the_reference(mesh_name):
    pytest.importorskip("jax")
    from jax.sharding import AbstractMesh as RefAbstractMesh
    from jax.sharding import PartitionSpec

    from repro.distributed.sharding import resolve_spec as ref_resolve

    from repro_torch.distributed.sharding import is_spec
    from repro_torch.models.state import flatten

    shape, axes = MESHES[mesh_name]
    mesh, ref_mesh = AbstractMesh(shape, axes), RefAbstractMesh(shape, axes)
    specs = list(ACTIVATION_SPECS)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        specs += flatten(get_model(cfg).param_specs(cfg), is_leaf=is_spec).values()
    for spec in set(specs):
        want = tuple(ref_resolve(PartitionSpec(*spec), ref_mesh))
        assert tuple(resolve_spec(spec, mesh)) == want, spec


def test_placements_shard_major_to_minor():
    from torch.distributed.tensor import Replicate, Shard

    mesh = AbstractMesh(*MESHES["2x16x16"])
    assert placements(resolve_spec(P("fsdp", "model"), mesh), mesh) == (Shard(0), Shard(0), Shard(1))
    assert placements(P(None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(NotImplementedError):
        placements(P(("data", "pod")), mesh)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The reference's single-device numbers, and the port's 2x2 job."""
    pytest.importorskip("jax")
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.launch.specs import demo_batch
    from repro.models.registry import get_model as ref_get_model
    from repro.train.steps import make_loss_fn

    from repro_torch.models.state import flatten

    workdir = tmp_path_factory.mktemp("dist")
    inputs, cells = {}, {}
    for arch in _dist_worker.ARCHS:
        cfg = ref_get_config(arch).reduced()
        cfg = cfg.with_(n_layers=2) if arch == "granite-8b" else cfg
        params, _ = ref_get_model(cfg).init_params(cfg, jax.random.PRNGKey(0))
        batch = demo_batch(cfg, BATCH, SEQ, seed=1)
        cells[arch] = (make_loss_fn(cfg), params, batch)
        inputs[arch] = {
            "params": jax.tree.map(np.asarray, params),
            "batch": {
                "tokens": np.asarray(batch["inputs"]["tokens"], np.int64),
                "labels": np.asarray(batch["labels"], np.int64),
            },
        }
        if "frames" in batch["inputs"]:
            inputs[arch]["batch"]["frames"] = np.asarray(batch["inputs"]["frames"], np.float32)
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ctx = _dist_worker.start(str(workdir))
    ref = {}
    try:  # the reference's numbers while the job runs
        for arch, (loss_fn, params, batch) in cells.items():
            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batch)
            ref[f"{arch}/grads"] = {k: np.asarray(v) for k, v in flatten(grads).items()}
            ref[f"{arch}/loss"] = float(loss)
    finally:
        try:
            _dist_worker.wait(ctx)
        except Exception as e:
            errors = sorted(workdir.glob("error*.txt"))
            raise AssertionError(errors[0].read_text() if errors else f"the job failed: {e}") from None
    with open(workdir / "results.pkl", "rb") as f:
        return ref, pickle.load(f)


@pytest.mark.parametrize("arch", _dist_worker.ARCHS)
def test_sharded_loss_equals_the_reference(job, arch):
    ref, got = job
    assert got[f"{arch}/loss"] == pytest.approx(ref[f"{arch}/loss"], abs=1e-4)
    assert got[f"{arch}/placements_match"]  # grads come in the parameters' layout


@pytest.mark.parametrize("arch", _dist_worker.ARCHS)
def test_sharded_gradients_equal_the_reference(job, arch):
    """Every leaf, a weight beside split rows or the one KV head beside
    split query heads included: its gradient sums every rank's share."""
    ref, got = job
    want, have = ref[f"{arch}/grads"], got[f"{arch}/grads"]
    assert list(have) == list(want) and (arch != "starcoder2-3b" or len(have) == 19)
    for k, v in want.items():
        np.testing.assert_allclose(have[k], v, err_msg=k, **GRAD_TOL)


def test_sharded_signsgd_step_equals_the_unsharded_step(job):
    _, got = job
    r = got["signsgd"]
    assert r["ef_is_dtensor"] and r["ef_placements_match"]
    assert r["sign_rule_mismatches"] == 0  # ±1 = the sign rule of the gathered acc
    sharded, plain = r["sharded/leaves"], r["plain/leaves"]
    assert list(sharded) == list(plain) and len(sharded) == 19
    flips = total = 0
    for k, (acc, signs) in plain.items():
        s_acc, s_signs = sharded[k]
        np.testing.assert_allclose(s_acc, acc, err_msg=k, **GRAD_TOL)
        flip = s_signs != signs
        # a sharded sum may round differently: a flip only where |acc| ~ 0
        assert np.all(np.abs(acc[flip]) < 1e-6), k
        flips += int(flip.sum())
        total += flip.size
    print(f"signSGD 2x2 vs unsharded: {flips} of {total} signs flip")
    for k, v in r["plain/params"].items():
        np.testing.assert_allclose(r["sharded/params"][k], v, err_msg=k, **GRAD_TOL)
    assert r["sharded/loss"] == pytest.approx(r["plain/loss"], abs=1e-4)


def test_sharded_adamw_step_equals_the_unsharded_step(job):
    _, got = job
    r = got["adamw"]
    assert r["sharded/loss"] == pytest.approx(r["plain/loss"], abs=1e-4)
    for k, v in r["plain/params"].items():
        np.testing.assert_allclose(r["sharded/params"][k], v, err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("target", ["1x2", "none"])
def test_checkpoint_restores_onto_another_mesh(job, target):
    _, got = job
    saved, r = got["signsgd"]["saved"], got[f"restore/{target}"]
    assert r["restored"] and r["step"] == 1
    for k, v in saved["params"].items():
        np.testing.assert_array_equal(r["params"][k], v, err_msg=k)
    for k, v in saved["mu"].items():
        np.testing.assert_array_equal(r["mu"][k], v, err_msg=k)
    if target == "none":
        assert r["placements"] == ["None"]
    else:
        assert all("Shard" in p or "Replicate" in p for p in r["placements"])


def test_meshes_take_the_ranks_that_exist(tmp_path):
    """One gloo rank: the production mesh needs 256, a host mesh is cut
    to the world, and a cuda mesh does not fall back to the gloo group."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_host_mesh, make_production_mesh

    init_process_group("cpu", init_method=f"file://{tmp_path}/pg")
    try:
        with pytest.raises(ValueError, match="over 1 ranks"):
            make_production_mesh(device_type="cpu")
        mesh = make_host_mesh(2, 2, device_type="cpu")
        assert tuple(mesh.mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
        with pytest.raises(RuntimeError, match="gloo"):
            make_host_mesh(1, 1, device_type="cuda")
    finally:
        dist.destroy_process_group()


def test_constrain_is_the_identity_off_a_mesh():
    from repro_torch.distributed.sharding import active_mesh, constrain

    x = torch.ones(2, 3)
    assert constrain(x, "data", None) is x
    with active_mesh(AbstractMesh((1, 1), ("data", "model"))):
        assert constrain(x, "data", None) is x
