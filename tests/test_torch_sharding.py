"""Logical axes, sharding specs and the tensor-parallel reduce plan, in pure
Python (no process group).

- ``Model.logical_axes()`` against the reference's axes tree (its
  ``init(abstract=True)``) for all eleven ``--arch`` ids at SMOKE width, key
  by key.
- ``distributed.sharding.specs_for_axes`` under tp, fsdp and dp against the
  reference's PartitionSpecs at ARCH width, on stand-in meshes of the shapes
  (4, 2), (16, 16) and (2, 16, 16): the reference's ``_spec_for`` reads only
  a mesh's ``axis_names`` and ``shape``, so a ``launch.mesh.Mesh`` layout
  serves both.
- ``split_axes``, the logical axes a tensor-parallel pass splits, against
  the reference's tp specs for every arch, which axes split at full width
  for the hybrid and the encoder-decoder at model 2 to 16, and
  ``Model.init(mesh=...)`` against the whole init's slices.
- ``shard_of``, the production layouts, and ``core.plan.plan_shards`` at
  full width: paper-transformer-base's lm_head (512 x 37000, chunk 64) has
  chunks that cross its column slices and is reduced in parts; every
  tensor's chunks, k and payload summed over the model ranks are the
  logical plan's.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.distributed import sharding as jsharding
from repro.models import build_model as jbuild
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.plan import plan_shards, plan_tensors
from repro_torch.core.scalecom import ScaleComConfig
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import build_model

MESHES = {
    "4x2": Mesh(("data", "model"), (4, 2)),
    "16x16": Mesh(("data", "model"), (16, 16)),
    "2x16x16": Mesh(("pod", "data", "model"), (2, 16, 16)),
}
POLICIES = ("tp", "fsdp", "dp")


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_logical_axes_match_reference(arch):
    _, axes = jbuild(jregistry.smoke(arch)).init(None, abstract=True)
    want = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(axes, is_leaf=_is_axes)[0]}
    got = dict(tree.flatten_with_path(build_model(registry.smoke(arch)).logical_axes()))
    assert list(got) == list(want)
    for path, axes in want.items():
        assert got[path] == axes, path
    shapes = {p: tuple(x.shape) for p, x in
              tree.flatten_with_path(build_model(registry.smoke(arch)).abstract_params())}
    assert all(len(shapes[p]) == len(a) for p, a in got.items())


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_specs_match_reference(arch):
    jparams, jaxes = jbuild(jregistry.arch(arch)).init(None, abstract=True)
    model = build_model(registry.arch(arch))
    abstract, axes = model.abstract_params(), model.logical_axes()
    for name, mesh in MESHES.items():
        for policy in POLICIES:
            want = {jax.tree_util.keystr(k): tuple(v) for k, v in
                    jax.tree_util.tree_flatten_with_path(
                        jsharding.specs_for_axes(jparams, jaxes, policy, mesh),
                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
            got = dict(tree.flatten_with_path(sharding.specs_for_axes(abstract, axes, policy,
                                                                       mesh)))
            assert got == want, (name, policy)


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_split_axes_match_reference(arch):
    """The logical axes a tp layout splits over "model", from the port's
    specs, are those the reference's PartitionSpecs put on "model", leaf by
    leaf: each such axis is split in every leaf that names it. Where the
    reference's specs split an axis in one leaf and keep it whole in
    another (rwkv6-3b at model 16: 2,560 channels split 160 a rank, two
    and a half heads, while ``tm_u``'s 40 heads stay whole), the port's
    layout raises, naming the axis and both leaves."""
    jparams, jaxes = jbuild(jregistry.arch(arch)).init(None, abstract=True)
    model = build_model(registry.arch(arch))
    abstract, axes = model.abstract_params(), model.logical_axes()
    flat_axes = dict(tree.flatten_with_path(axes))
    for name, mesh in MESHES.items():
        jspecs = jax.tree_util.tree_flatten_with_path(
            jsharding.specs_for_axes(jparams, jaxes, "tp", mesh),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        entries = [(ax, entry == "model") for k, spec in jspecs
                   for ax, entry in zip(flat_axes[jax.tree_util.keystr(k)], tuple(spec))
                   if ax is not None]
        want = {ax for ax, split in entries if split}
        mixed = sorted(want & {ax for ax, split in entries if not split})
        specs = sharding.specs_for_axes(abstract, axes, "tp", mesh)
        if mixed:
            with pytest.raises(ValueError, match=f"logical axis {mixed[0]!r} is split over "
                                                 f"'model' in .* and whole in "):
                sharding.split_axes(specs, axes)
            continue
        got = sharding.split_axes(specs, axes)
        assert got == want, name
        assert got <= {"vocab", "heads", "kv", "mlp", "experts"}, name


# arch -> model size -> (the logical axes split, kv columns a rank)
FULL_WIDTH_SPLITS = {
    # 2,560 channels and 10 heads of 256 divide by every size; its one kv
    # head's 256 columns go 128 / 64 / 32 / 16 a rank; 256,000 vocabulary rows
    "recurrentgemma-2b": {m: ({"heads", "kv", "mlp", "vocab"}, 256 // m) for m in (2, 4, 8, 16)},
    # a vocabulary of 51,865 (odd) stays whole at every size
    "whisper-medium": {m: ({"heads", "kv", "mlp"}, 1024 // m) for m in (2, 4, 8, 16)},
}


@pytest.mark.parametrize("model_size", [2, 4, 8, 16])
@pytest.mark.parametrize("arch", list(FULL_WIDTH_SPLITS))
def test_split_axes_at_full_width_hybrid_encdec(arch, model_size):
    """The full-width hybrid and encoder-decoder at model 2, 4, 8 and 16:
    the axes split, a rank's kv columns, and whisper-medium's vocabulary
    tables whole."""
    model = build_model(registry.arch(arch))
    mesh = Mesh(("data", "model"), (1, model_size))
    specs = sharding.specs_for_axes(model.abstract_params(), model.logical_axes(), "tp", mesh)
    want, kv_cols = FULL_WIDTH_SPLITS[arch][model_size]
    assert sharding.split_axes(specs, model.logical_axes()) == want
    flat = dict(tree.flatten_with_path(specs))
    shapes = {p: tuple(x.shape) for p, x in tree.flatten_with_path(model.abstract_params())}
    wk = next(p for p in flat if p.endswith("['attn_wk']"))
    assert shapes[wk][-1] // model_size == kv_cols and flat[wk][-1] == "model"
    if "vocab" not in want:
        assert flat["['tok_embed']"] == (None, None) and flat["['lm_head']"] == (None, None)


def test_split_axes_refuses_an_axis_split_in_one_leaf_only():
    mesh = MESHES["4x2"]
    abstract = {"a": torch.empty(8, 6, device="meta"), "b": torch.empty(6, 7, device="meta")}
    axes = {"a": ("mlp", "embed"), "b": ("embed", "mlp")}
    specs = sharding.specs_for_axes(abstract, axes, "tp", mesh)
    with pytest.raises(ValueError, match="'mlp' is split over 'model' in \\['a'\\] and whole "
                                         "in \\['b'\\]"):
        sharding.split_axes(specs, axes)
    assert sharding.split_axes(specs, {"a": ("mlp", "embed"), "b": ("embed", None)}) == {"mlp"}


@pytest.mark.parametrize("arch", ["paper-transformer-base", "starcoder2-3b"])
@pytest.mark.parametrize("coords", [(0, 0), (1, 1), (0, 3)])
def test_sharded_init_is_the_whole_inits_slices(arch, coords):
    """``Model.init(mesh=...)`` keeps only the rank's slice of each drawn
    layer: bitwise the slice of the whole init from the same generator
    state, leaf for leaf (a layout with coordinates is enough)."""
    shape = (2, 4)
    mesh = Mesh(("data", "model"), shape, coords=dict(zip(("data", "model"), coords)))
    model = build_model(registry.smoke(arch), compute_dtype="float32")
    whole = model.init(torch.Generator().manual_seed(3), "cpu")
    mine = model.init(torch.Generator().manual_seed(3), "cpu", mesh=mesh)
    specs = dict(tree.flatten_with_path(sharding.specs_for_axes(whole, model.logical_axes(),
                                                                "tp", mesh)))
    assert any("model" in s for s in specs.values())
    flat = tree.flatten_with_path(mine)
    assert [p for p, _ in flat] == [p for p, _ in tree.flatten_with_path(whole)]
    for (path, got), want in zip(flat, tree.leaves(whole)):
        assert torch.equal(got, sharding.shard_of(want, specs[path], mesh)), path


def test_specs_follow_the_divisibility_rule():
    mesh = MESHES["4x2"]
    abstract = {"a": torch.empty(6, 7, device="meta"), "b": torch.empty(8, 8, device="meta"),
                "c": torch.empty(3, 4, device="meta")}
    axes = {"a": ("vocab", "mlp"), "b": ("heads", "kv"), "c": ("embed", "mlp")}
    got = sharding.specs_for_axes(abstract, axes, "tp", mesh)
    assert got == {"a": ("model", None), "b": ("model", None), "c": (None, "model")}
    fsdp = sharding.specs_for_axes(abstract, axes, "fsdp", mesh)
    assert fsdp["c"] == (None, "model") and fsdp["b"] == ("model", None)
    with pytest.raises(ValueError, match="unknown sharding policy 'zero'"):
        sharding.rules_for_policy("zero")


def test_shard_of_slices_and_copies():
    mesh = Mesh(("data", "model"), (2, 4), coords={"data": 1, "model": 2})
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    s = sharding.shard_of(x, (None, "model"), mesh)
    assert torch.equal(s, x[:, 6:9]) and s.is_contiguous()
    s.add_(1.0)
    assert torch.equal(x[:, 6:9], torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)[:, 6:9])
    assert torch.equal(sharding.shard_of(x, ("data", "model"), mesh), x[4:8, 6:9])
    assert torch.equal(sharding.shard_of(x, ("model", None), mesh, {"model": 3}), x[6:8])
    with pytest.raises(ValueError, match="does not split into 4"):
        sharding.shard_of(torch.zeros(6), ("model",), mesh)


def test_production_mesh_is_a_layout():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    pod = make_production_mesh(multi_pod=True)
    assert pod.shape == {"pod": 2, "data": 16, "model": 16} and pod.size == 512
    with pytest.raises(ValueError, match="a layout only"):
        pod.group("model")
    with pytest.raises(ValueError, match="mesh axes"):
        Mesh(("data", "data"), (2, 2))


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("compressor", ["clt_k", "true_topk", "local_topk", "random_k"])
@pytest.mark.parametrize("arch,chunk", [("paper-transformer-base", 64), ("starcoder2-3b", 64)])
def test_shard_plans_sum_to_the_logical_plan(arch, chunk, compressor, exact):
    """The full-width plans on a model axis of 2, for every compressor and
    the exact path: chunks, k and payload summed over the model ranks equal
    the logical plan's; paper-transformer-base's lm_head has chunks across
    its column slices (37000 % 64 = 8) and runs in parts, its tok_embed (row
    slices) where it lies; an exact tensor takes the exact route, split or
    not, its k in ranges of the model ranks."""
    model = build_model(registry.arch(arch))
    abstract, axes = model.abstract_params(), model.logical_axes()
    mesh = Mesh(("data", "model"), (4, 2))
    specs = tree.leaves(sharding.specs_for_axes(abstract, axes, "tp", mesh))
    cfg = ScaleComConfig(compressor=CompressorConfig(compressor, chunk=chunk, exact=exact),
                         min_size=1024)
    flat = tree.flatten_with_path(abstract)
    plans = plan_tensors(tuple((p, tuple(x.shape), 4) for p, x in flat), cfg,
                         frozenset(p for p, x in flat if x.numel() >= 1024))
    shards = [plan_shards(plans, specs, 2, i) for i in range(2)]
    routes = {p.path: s.route for p, s in zip(plans, shards[0])}
    if exact:
        assert {routes[p.path] for p in plans if not p.dense} == {"exact"}
    elif arch == "paper-transformer-base":
        assert routes["['lm_head']"] == "part" and routes["['tok_embed']"] == "local"
        assert routes["['blocks']['mlp_up']"] == "local"
    else:
        assert routes["['lm_head']"] == "local"
    # replicated: reduced in halves, unless exact and compressed
    ln = next(p for p in plans if p.path == "['ln_final_scale']")
    assert routes[ln.path] == ("exact" if exact and not ln.dense else "part")
    for j, plan in enumerate(plans):
        mine = [s[j] for s in shards]
        assert sum(s.n_chunks for s in mine) == plan.n_chunks, plan.path
        assert sum(s.k for s in mine) == plan.k, plan.path
        assert sum(s.bytes_payload for s in mine) == pytest.approx(plan.bytes_payload, rel=1e-12)
        if mine[0].route == "local":
            assert all(s.local_shape[s.dim] * 2 == plan.shape[s.dim] for s in mine)
        if mine[0].route == "exact":
            assert [s.bounds[i] for i, s in enumerate(mine)] == [
                (0, plan.k // 2 + plan.k % 2), (plan.k // 2 + plan.k % 2, plan.k)]
