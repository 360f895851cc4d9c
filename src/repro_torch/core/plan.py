"""Per-tensor reduce planning: the *plan* stage of ``scalecom_reduce``.

The port of ``repro.core.plan``. Plans are pure Python, resolved once per
tree structure and cached: per tensor the compressor after ``rate_rules``,
the ``min_size`` dense fallback, grouping, the chunk layout, the residue
storage shape and execute work view, and the wire bytes. ``plan_buckets``
packs the plans into the launch buckets of the bucketed reduce
(``core.overlap``). ``plan_shards`` maps the plan of each logical tensor
onto one rank of a tensor-parallel model axis.

Byte accounting, one rule for both layouts (per-worker transmit bytes for
one tensor and step; fp32 values, int32 indices; k = n_chunks * topm):

  dense                      4 * size
  values (every compressor)  4 * k
  indices:
    local_topk               + 4 * k       every worker ships its own set
    clt_k / true_topk        + 4 * k / G   the leader's set, amortized over G
    random_k                 + 0           re-derived from the step counter
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

from repro_torch.core.chunked import num_chunks
from repro_torch.core.compressors import CompressorConfig, exact_k
from repro_torch.core.rates import resolve_compressor
from repro_torch.core.state import CODECS, codec_signature, resolve_layout, storage_shape

Shape = Tuple[int, ...]

__all__ = ["TensorPlan", "Bucket", "ShardPlan", "plan_tensors", "plan_buckets", "plan_shards",
           "payload_bytes"]


@dataclasses.dataclass(frozen=True)
class TensorPlan:
    """Everything the execute stage needs to know about one tensor.

    path:          key-path string (also the residue-dict key)
    shape:         parameter shape (no worker axis)
    size:          element count
    groups:        G, the ScaleCom worker count after hierarchical folding
    layout:        resolved chunk layout ("flat" | "rowwise")
    comp:          resolved CompressorConfig, or None => dense reduce
    storage:       residue storage shape (no worker axis)
    work:          execute-stage view: (size,) for flat and the exact path,
                   the parameter shape for rowwise; chunks always run along
                   work[-1]
    n_chunks:      total chunks across the tensor in this layout
    k:             values each worker contributes per step
    bytes_dense:   4 * size
    bytes_payload: per-worker wire bytes under the rule above
    """

    path: str
    shape: Shape
    size: int
    groups: int
    layout: str
    comp: Optional[CompressorConfig]
    storage: Shape
    work: Shape
    n_chunks: int
    k: int
    bytes_dense: float
    bytes_payload: float

    @property
    def dense(self) -> bool:
        return self.comp is None


# Per-worker INDEX bytes for k kept values, by compressor (see module docstring)
_INDEX_BYTES = {
    "clt_k": lambda k, G: 4.0 * k / G,
    "true_topk": lambda k, G: 4.0 * k / G,
    "local_topk": lambda k, G: 4.0 * k,
    "random_k": lambda k, G: 0.0,
}


def payload_bytes(comp: Optional[CompressorConfig], k: int, groups: int) -> float:
    """Per-worker wire bytes for k kept values."""
    if comp is None or comp.name == "none":
        raise ValueError("payload_bytes is for compressed tensors; dense is 4*size")
    return 4.0 * k + _INDEX_BYTES[comp.name](k, groups)


def _raise_state_drift(path, shape, G, layout, residue_dtype, actual, expected):
    """Name what drifted between init_state and this reduce, then raise."""
    other = "rowwise" if layout == "flat" else "flat"
    causes = []
    if actual == codec_signature(residue_dtype, G, storage_shape(shape, other)):
        causes.append(
            f"the residue was initialized under layout={other!r} but this "
            f"reduce resolved layout={layout!r} (e.g. $SCALECOM_TORCH_LAYOUT "
            f"changed between init_state and scalecom_reduce)"
        )
    q_shape = dict((name, sh) for name, sh, _ in actual).get("q")
    if q_shape and q_shape[0] != G and actual == codec_signature(
        residue_dtype, q_shape[0], storage_shape(shape, layout)
    ):
        causes.append(
            f"the residue carries {q_shape[0]} worker rows but this reduce "
            f"folds to G={G} workers (membership or `groups` changed); "
            f"core.state.remap_state(state, {q_shape[0]}, {G}) moves the EF "
            f"mass to the new worker count"
        )
    for name in CODECS:
        if name != residue_dtype and actual == codec_signature(
            name, G, storage_shape(shape, layout)
        ):
            causes.append(
                f"the residue was encoded by the {name!r} codec but "
                f"ScaleComConfig.residue_dtype={residue_dtype!r}"
            )
    detail = "; ".join(causes) if causes else f"expected {expected}, found {actual}"
    raise ValueError(
        f"ScaleCom state drift on tensor {path!r}: the stored residue "
        f"encoding does not match what this reduce's plan (layout={layout!r}, "
        f"residue_dtype={residue_dtype!r}, G={G}) will decode — {detail}. "
        f"Remediation: re-init the state (core.state.init_state) with the "
        f"current config, or pin the layout explicitly on both sides; on a "
        f"membership change use core.state.remap_state."
    )


def _plan_one(path, shape, n_stack, layout, base, rate_rules, min_size, groups,
              has_residue, residue_dtype, enc_sig) -> TensorPlan:
    size = 1
    for d in shape:
        size *= d
    if groups is not None and (groups < 1 or n_stack % groups != 0):
        raise ValueError(
            f"n={n_stack} workers are not divisible into groups={groups} "
            f"(tensor {path!r}): hierarchical grouping needs n % groups == 0 "
            f"with groups >= 1"
        )
    G = groups if groups is not None else n_stack
    comp: Optional[CompressorConfig] = base
    if rate_rules:
        comp = resolve_compressor(path, base, rate_rules)
    if comp is not None and (comp.name == "none" or size < min_size or not has_residue):
        comp = None

    storage = storage_shape(shape, layout)
    if comp is not None and enc_sig is not None:
        expected = codec_signature(residue_dtype, G, storage)
        if enc_sig != expected:
            _raise_state_drift(path, shape, G, layout, residue_dtype, enc_sig, expected)
    if comp is None:
        return TensorPlan(
            path=path, shape=shape, size=size, groups=G, layout=layout,
            comp=None, storage=storage, work=(size,), n_chunks=0, k=0,
            bytes_dense=4.0 * size, bytes_payload=4.0 * size,
        )
    # the exact (dense top-k) analysis path always runs on the flat view
    work = (size,) if (layout == "flat" or comp.exact) else storage
    rows = 1
    for d in work[:-1]:
        rows *= d
    nch = rows * num_chunks(work[-1], comp.chunk)
    k = exact_k(size, comp) if comp.exact else nch * comp.topm
    return TensorPlan(
        path=path, shape=shape, size=size, groups=G, layout=layout,
        comp=comp, storage=storage, work=work, n_chunks=nch, k=k,
        bytes_dense=4.0 * size, bytes_payload=payload_bytes(comp, k, G),
    )


@functools.lru_cache(maxsize=128)
def _plan_cached(leaves, residue_paths, layout, base, rate_rules, min_size,
                 groups, residue_dtype) -> Tuple[TensorPlan, ...]:
    # residue_paths holds bare paths (no drift check) or the (path,
    # signature) pairs of core.state.residue_signature
    sigs = {e[0]: e[1] for e in residue_paths if isinstance(e, tuple)}
    paths = {e if isinstance(e, str) else e[0] for e in residue_paths}
    return tuple(
        _plan_one(path, shape, n_stack, layout, base, rate_rules, min_size,
                  groups, path in paths, residue_dtype, sigs.get(path))
        for path, shape, n_stack in leaves
    )


def plan_tensors(leaves, cfg, residue_paths) -> Tuple[TensorPlan, ...]:
    """Plans for a flattened gradient tree, cached per tree structure.

    leaves:        tuple of (path, param_shape, worker_axis_size)
    cfg:           ScaleComConfig (only plan-relevant fields key the cache)
    residue_paths: paths that carry EF state, as bare strings or as the
                   (path, signature) pairs of ``residue_signature``; with
                   signatures, layout or worker-count drift between the
                   stored residues and this plan raises a named ValueError.
    """
    return _plan_cached(
        tuple(leaves),
        frozenset(residue_paths),
        resolve_layout(cfg.layout),
        cfg.compressor,
        tuple(cfg.rate_rules),
        cfg.min_size,
        cfg.groups,
        cfg.residue_dtype,
    )


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One launch unit of the bucketed reduce (``core.overlap`` runs them).

    index:         position in the schedule
    leaf_ids:      indices into the plan/leaf tuple, in reverse leaf order
                   (backward makes the last parameters' gradients first)
    bytes_dense:   summed dense gradient bytes, the packing target
    bytes_payload: summed per-worker wire bytes
    """

    index: int
    leaf_ids: Tuple[int, ...]
    bytes_dense: float
    bytes_payload: float


@functools.lru_cache(maxsize=128)
def _buckets_cached(plans: Tuple[TensorPlan, ...], bucket_bytes: int) -> Tuple[Bucket, ...]:
    buckets = []
    ids: list = []
    acc_dense = acc_payload = 0.0
    for i in range(len(plans) - 1, -1, -1):  # grad-ready (reverse leaf) order
        p = plans[i]
        if ids and acc_dense + p.bytes_dense > bucket_bytes:
            buckets.append(Bucket(len(buckets), tuple(ids), acc_dense, acc_payload))
            ids, acc_dense, acc_payload = [], 0.0, 0.0
        ids.append(i)
        acc_dense += p.bytes_dense
        acc_payload += p.bytes_payload
    if ids:
        buckets.append(Bucket(len(buckets), tuple(ids), acc_dense, acc_payload))
    return tuple(buckets)


def plan_buckets(plans: Tuple[TensorPlan, ...], bucket_bytes: int) -> Tuple[Bucket, ...]:
    """Pack plans into launch buckets of about ``bucket_bytes`` dense bytes (cached).

    Greedy in reverse leaf order: a bucket closes when the next tensor would
    push its dense bytes past the target. Every tensor lands in exactly one
    bucket, dense fallbacks included; a tensor larger than the target gets a
    bucket of its own. The plans themselves are untouched, so bucketing
    changes launch order only.
    """
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    return _buckets_cached(tuple(plans), int(bucket_bytes))


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """One logical tensor's reduce on one rank of the ranks a worker's
    parameters are split over (the tensor-parallel step: a model axis of
    ``parts`` ranks under ``tp``, a pod's (data, model) plane under
    ``fsdp``), from its logical ``plan``: the ``min_size`` fallback, chunk
    count, k and wire bytes are the logical tensor's, split among those
    ranks.

    dim:    the first parameter dim the rank's block cuts (under ``tp`` the
            one split over the model axis), None if replicated
    cuts:   (dim, mesh axis, parts, index) of each cut dim
    unique: whether the block is the rank's alone (cut over every axis of
            the split): else the ranks along an uncut axis hold copies
    first:  whether the rank is the first of those copies
    route:  "dense"  a dense tensor whose block is unique: all-reduced over
                     the workers' group where it lies
            "local"  a compressed tensor whose unique block, in its own work
                     view, is a run of whole chunks of the logical view:
                     reduced where it lies
            "part"   the rest (a replicated tensor or one the rank holds a
                     copy of; a split compressed one whose chunks cross the
                     blocks): the rank reduces its ``bounds[index]`` of the
                     logical work view's units (chunks of a 1-D view, rows
                     of a rowwise one, elements of a dense tensor), and the
                     parts are gathered over the split's ranks
            "exact"  the exact path (a dense top-k of ``exact_k`` over the
                     logical tensor, split or not): every rank selects on
                     the logical tensor, and the k offsets and values go
                     over the workers' group in ``bounds``' ranges of them,
                     one a rank of the split
    work:   the view this rank's reduce runs on ((size,), or rows; the
            exact route's the logical (size,))
    bounds: [(lo, hi)] per model rank, in units (the "part" and "exact"
            routes)
    unit:   elements per unit of ``bounds`` (the exact route's units are
            offsets)
    n_chunks, k, bytes_payload: this rank's share of the plan's
    """

    plan: TensorPlan
    dim: Optional[int]
    route: str
    local_shape: Shape
    work: Shape
    bounds: Tuple[Tuple[int, int], ...]
    unit: int
    n_chunks: int
    k: int
    bytes_payload: float
    cuts: Tuple[Tuple[int, str, int, int], ...] = ()
    unique: bool = False
    first: bool = True


def _even(n: int, parts: int) -> Tuple[Tuple[int, int], ...]:
    """``n`` units in ``parts`` consecutive ranges, the first ``n % parts``
    one longer."""
    q, r = divmod(n, parts)
    out, lo = [], 0
    for i in range(parts):
        hi = lo + q + (i < r)
        out.append((lo, hi))
        lo = hi
    return tuple(out)


def _whole_chunks(plan: TensorPlan, cuts) -> bool:
    """Whether every rank's block (``cuts``), in its own work view, is a
    run of whole chunks of the logical view, each in its logical order."""
    chunk, shape = plan.comp.chunk, plan.shape
    dim, _, parts, _ = cuts[-1]  # the innermost cut sets the runs
    width = shape[dim] // parts
    if len(plan.work) == 1:  # flat: runs of width * inner elements, shape[dim] * inner apart
        inner = 1
        for d in shape[dim + 1:]:
            inner *= d
        return (width * inner) % chunk == 0
    return dim < len(shape) - 1 or width % chunk == 0  # rowwise: whole rows, or aligned cuts


def grid_coords(axes, j: int) -> dict:
    """The coordinates ({mesh axis: index}) of rank ``j`` of a group whose
    ranks lie row-major over ``axes`` ((mesh axis, size) pairs)."""
    out = {}
    for name, size in reversed(tuple(axes)):
        j, out[name] = divmod(j, size)
    return out


def first_holder(cut_axes, coords: dict) -> bool:
    """Whether the rank at ``coords`` is the first of the ranks that hold
    its block alike: index 0 along every axis of ``coords`` that the block
    is not cut over (``cut_axes``)."""
    return all(i == 0 for ax, i in coords.items() if ax not in cut_axes)


def _shard_one(plan: TensorPlan, spec, axes, index: int) -> ShardPlan:
    sizes = dict(axes)
    coords = grid_coords(axes, index)
    cuts = tuple((d, ax, sizes[ax], coords[ax]) for d, ax in enumerate(spec)
                 if ax in sizes and sizes[ax] > 1)
    held = {c[1] for c in cuts}
    unique = bool(cuts) and all(ax in held for ax, size in axes if size > 1)
    first = first_holder(held, coords)
    dim = cuts[0][0] if cuts else None
    parts = 1
    for _, size in axes:
        parts *= size
    local = list(plan.shape)
    for d, _, p, _ in cuts:
        local[d] //= p
    local = tuple(local)
    size = 1
    for d in local:
        size *= d
    extra = dict(cuts=cuts, unique=unique, first=first)
    if plan.dense:
        if unique:
            return ShardPlan(plan, dim, "dense", local, (size,), (), 1, 0, 0, 4.0 * size, **extra)
        bounds = _even(plan.size, parts)
        lo, hi = bounds[index]
        return ShardPlan(plan, dim, "part", local, (hi - lo,), bounds, 1, 0, 0, 4.0 * (hi - lo),
                         **extra)
    comp = plan.comp
    if comp.exact:
        bounds = _even(plan.k, parts)
        lo, hi = bounds[index]
        c_lo, c_hi = _even(plan.n_chunks, parts)[index]
        return ShardPlan(plan, dim, "exact", local, plan.work, bounds, 1, c_hi - c_lo, hi - lo,
                         payload_bytes(comp, hi - lo, plan.groups) if hi > lo else 0.0, **extra)
    if unique and _whole_chunks(plan, cuts):
        work = (size,) if len(plan.work) == 1 else local
        rows = 1
        for d in work[:-1]:
            rows *= d
        nch = rows * num_chunks(work[-1], comp.chunk)
        k = nch * comp.topm
        return ShardPlan(plan, dim, "local", local, work, (), 1, nch, k,
                         payload_bytes(comp, k, plan.groups), **extra)
    if len(plan.work) == 1:
        bounds = _even(plan.n_chunks, parts)
        lo, hi = bounds[index]
        elems = min(hi * comp.chunk, plan.size) - lo * comp.chunk if hi > lo else 0
        nch, work, unit = hi - lo, (elems,), comp.chunk
    else:
        rows = plan.size // plan.work[-1]
        bounds = _even(rows, parts)
        lo, hi = bounds[index]
        nch = (hi - lo) * num_chunks(plan.work[-1], comp.chunk)
        work, unit = (hi - lo, plan.work[-1]), plan.work[-1]
    k = nch * comp.topm
    return ShardPlan(plan, dim, "part", local, work, bounds, unit, nch, k,
                     payload_bytes(comp, k, plan.groups) if k else 0.0, **extra)


def plan_shards(plans, specs, parts: int, index: int, axes=None) -> Tuple[ShardPlan, ...]:
    """Each logical plan of ``plans`` on rank ``index`` of the ranks a
    worker's parameters are split over: ``specs`` holds the leaves'
    sharding specs in the same order (``distributed.sharding``), ``axes``
    the split's (mesh axis, size) pairs, its ranks row-major over them
    (default: a model axis of ``parts`` ranks, the ``tp`` step's; the
    ``fsdp`` step's is (("data", D), ("model", M)), ``parts`` = D x M).
    Summed over those ranks, the chunks, k and payload bytes are the
    logical plan's, for every compressor and the exact path."""
    axes = (("model", parts),) if axes is None else tuple(axes)
    total = 1
    for _, size in axes:
        total *= size
    if total != parts:
        raise ValueError(f"the split's axes {axes} hold {total} ranks, not {parts}")
    return tuple(_shard_one(p, tuple(s), axes, index) for p, s in zip(plans, specs))
