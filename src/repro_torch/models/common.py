"""Shared model pieces: parameter init, layernorm and RMSNorm, RoPE and
sinusoidal positions, the GELU and SwiGLU MLPs, embeddings, the chunked
cross-entropy and ``remat``, the port's ``jax.checkpoint``.

The port of ``repro.models.common``. Parameters are
plain nested dicts of tensors with the JAX package's names and stacked
shapes, so a JAX parameter tree carries across (``models.convert``) and the
residue keys match.

Mixed precision, as the reference places it: parameters are drawn in fp32
and stored in the parameter dtype; every weight is cast to the compute
dtype where it is used (``dtype`` arguments), so a parameter's gradient
comes back in its own dtype (a cast's backward casts back). The norms and
RoPE compute in fp32 and return the input's dtype; the cross-entropy's
logits are fp32.

``remat(fn)`` is ``fn`` whose backward recomputes it: a
``torch.autograd.Function`` that saves only its tensor inputs and, in its
backward, runs ``fn`` again under ``torch.func.vjp``. Its vmap rule is
generated, so it works under ``torch.func.vmap(grad_and_value(...))`` (the
batched per-worker pass) as under ``torch.autograd.grad``, and nested (a
rematerialised attention chunk inside a rematerialised layer). Its
cotangents are returned detached: ``torch.func.grad`` runs the backward
with create_graph, and a cotangent's history would keep every layer's
recomputed activations to the end of the backward. So gradients of
gradients do not pass it. ``torch.utils.checkpoint`` does not work under
``torch.func.grad``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.distributed import sharding, tensor_parallel

Tensor = torch.Tensor

__all__ = [
    "ParamStore",
    "layernorm",
    "rmsnorm",
    "init_norm",
    "apply_norm",
    "apply_rope",
    "sinusoidal_positions",
    "sinusoidal_positions_at",
    "gelu_mlp",
    "init_swiglu",
    "swiglu",
    "embed_tokens",
    "lm_logits",
    "chunked_xent",
    "remat",
]


class ParamStore:
    """Collects parameters during init, drawing from one explicit generator,
    and each parameter's logical axes (``axes``, a parallel tree of tuples),
    as the reference's store records them: the names
    ``distributed.sharding`` maps onto mesh axes ("vocab", "embed",
    "heads", "kv", "mlp", "experts", "layers", "conv", "state" or None),
    with "layers" in front of a stacked leaf's.

    Normal draws come from ``generator``, on the generator's device, in
    fp32, and are then moved to ``device`` and cast to ``param_dtype``
    (round to nearest even), as the reference draws in fp32 and casts: a
    bf16 init is the fp32 init rounded. A CPU generator gives the same
    values whatever the device, a CUDA one draws on the card (no host draws
    to wait for). A stacked leaf is drawn one layer at a time into its
    stack, so the fp32 draw never holds more than one layer of it (48
    layers of internvl2-26b's MLP are 19 GB in fp32). On the ``meta``
    device nothing is drawn: the leaves are shapes only (the reference's
    ``abstract=True``). With ``specs`` (a spec per leaf,
    ``distributed.sharding``) and ``mesh`` (a grid with coordinates) each
    drawn layer is cut to this rank's slice at once: the draws are the
    whole init's, and only the slices are kept.
    """

    def __init__(self, generator: Optional[torch.Generator], device: torch.device,
                 param_dtype: torch.dtype = torch.float32, specs: Optional[Dict] = None,
                 mesh=None):
        self.gen = generator
        self.device = device
        self.param_dtype = param_dtype
        self.specs = specs
        self.mesh = mesh
        self.params: Dict[str, object] = {}
        self.axes: Dict[str, object] = {}

    def _put(self, name, shape, axes, stacked: int, draw: Callable):
        """``draw(shape)`` (an fp32 tensor) as the parameter ``name``,
        ``stacked`` times on a new leading axis, one draw a layer."""
        full = ((stacked,) if stacked else ()) + tuple(shape)
        ax = (("layers",) if stacked else ()) + tuple(axes)
        if len(ax) != len(full):
            raise ValueError(f"parameter {name!r}: axes {ax} for shape {full}")
        self.axes[name] = ax
        if self.device.type == "meta":
            self.params[name] = torch.empty(full, dtype=self.param_dtype, device=self.device)
            return
        layer = lambda: draw(tuple(shape))  # noqa: E731
        if self.specs is not None:
            spec = self.specs[name]
            if stacked and spec[0] is not None:
                raise ValueError(f"parameter {name!r}: its layers are split ({spec})")
            one = spec[1:] if stacked else spec
            layer = lambda: sharding.shard_of(draw(tuple(shape)), one, self.mesh)  # noqa: E731
            full = full[:len(full) - len(shape)] + tuple(
                n // (self.mesh.shape[a] if a else 1) for n, a in zip(shape, one))
        if not stacked:
            self.params[name] = layer().to(self.device, self.param_dtype)
        else:
            out = torch.empty(full, dtype=self.param_dtype, device=self.device)
            for i in range(stacked):
                out[i] = layer()
            self.params[name] = out

    def dense(self, name, shape, axes, scale: Optional[float] = None, stacked: int = 0):
        """Normal(0, scale) init; scale defaults to 1/sqrt(fan_in)."""
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        s = scale if scale is not None else fan_in**-0.5
        self._put(name, shape, axes, stacked, lambda sh: torch.randn(
            sh, generator=self.gen, dtype=torch.float32, device=self.gen.device) * s)

    def zeros(self, name, shape, axes, stacked: int = 0):
        self._put(name, shape, axes, stacked,
                  lambda sh: torch.zeros(sh, dtype=torch.float32, device=self.device))

    def ones(self, name, shape, axes, stacked: int = 0):
        self._put(name, shape, axes, stacked,
                  lambda sh: torch.ones(sh, dtype=torch.float32, device=self.device))

    def subtree(self, name: str) -> "ParamStore":
        sub = ParamStore(self.gen, self.device, self.param_dtype,
                         None if self.specs is None else self.specs[name], self.mesh)
        self.params[name] = sub.params
        self.axes[name] = sub.axes
        return sub


def layernorm(x: Tensor, scale: Tensor, bias: Tensor, eps: float = 1e-5) -> Tensor:
    """Layernorm with the biased variance, in fp32 as the JAX package
    computes it; returns ``x``'s dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dt)


def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """RMSNorm (a scale, no bias) in fp32, as the JAX package computes it;
    returns ``x``'s dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.to(torch.float32)).to(dt)


def init_norm(cfg, store: ParamStore, prefix: str, d: int, stacked: int = 0):
    """``cfg.norm``'s parameters: a scale, and for layernorm a bias."""
    store.ones(f"{prefix}_scale", (d,), ("embed",), stacked=stacked)
    if cfg.norm == "layernorm":
        store.zeros(f"{prefix}_bias", (d,), ("embed",), stacked=stacked)


def apply_norm(cfg, x: Tensor, p: Dict[str, Tensor], prefix: str) -> Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p[f"{prefix}_scale"], p[f"{prefix}_bias"])
    return rmsnorm(x, p[f"{prefix}_scale"])


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotary embedding over split halves, in fp32; returns ``x``'s dtype.
    x: (..., S, heads, hd); positions: (S,)."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = positions[..., None].to(torch.float32) * freqs  # (S, hd/2)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device=None) -> Tensor:
    """(seq, d) fp32 table: sin of pos / 10000^(2i/d) in the first half, cos in
    the second, computed in float32 as the reference does (its callers cast
    it to the compute dtype)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10_000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_positions_at(pos: int, d: int, device=None) -> Tensor:
    """Row ``pos`` of ``sinusoidal_positions`` as (1, 1, d), bit for bit: the
    same float32 ops on one position. The position is filled on the device,
    so a decode step copies nothing from the host."""
    p = torch.full((1, 1), pos, dtype=torch.float32, device=device)
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = p / torch.pow(10_000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[None]


def init_gelu_mlp(store: ParamStore, d: int, f: int, stacked: int = 0):
    store.dense("mlp_up", (d, f), ("embed", "mlp"), stacked=stacked)
    store.dense("mlp_down", (f, d), ("mlp", "embed"), stacked=stacked)
    store.zeros("mlp_up_b", (f,), ("mlp",), stacked=stacked)
    store.zeros("mlp_down_b", (d,), ("embed",), stacked=stacked)


def gelu_mlp(p: Dict[str, Tensor], x: Tensor, dtype: torch.dtype, tp=None) -> Tensor:
    """GELU MLP with biases, in ``dtype``; jax.nn.gelu's default is the tanh
    approximation. With ``tp`` (a ``tensor_parallel.ModelAxis``) this rank
    holds a column slice of ``mlp_up``/``mlp_up_b`` and the matching rows of
    ``mlp_down``: its product is summed over the model group before the
    replicated ``mlp_down_b``."""
    if tp is not None:
        x = tp.copy(x)
    h = F.gelu(x @ p["mlp_up"].to(dtype) + p["mlp_up_b"].to(dtype), approximate="tanh")
    out = h @ p["mlp_down"].to(dtype)
    return (out if tp is None else tp.reduce(out)) + p["mlp_down_b"].to(dtype)


def init_swiglu(store: ParamStore, d: int, f: int, stacked: int = 0):
    store.dense("mlp_gate", (d, f), ("embed", "mlp"), stacked=stacked)
    store.dense("mlp_up", (d, f), ("embed", "mlp"), stacked=stacked)
    store.dense("mlp_down", (f, d), ("mlp", "embed"), stacked=stacked)


def swiglu(p: Dict[str, Tensor], x: Tensor, dtype: torch.dtype, tp=None) -> Tensor:
    """silu(x @ gate) * (x @ up) @ down, no biases, in ``dtype``. With ``tp``
    the gate and up columns and the down rows are this rank's, the product
    summed over the model group."""
    if tp is not None:
        x = tp.copy(x)
    out = ((F.silu(x @ p["mlp_gate"].to(dtype)) * (x @ p["mlp_up"].to(dtype)))
           @ p["mlp_down"].to(dtype))
    return out if tp is None else tp.reduce(out)


def init_embeddings(cfg, store: ParamStore):
    store.dense("tok_embed", (cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=1.0)
    if not cfg.tie_embeddings:
        store.dense("lm_head", (cfg.d_model, cfg.vocab), ("embed", "vocab"))


def embed_tokens(p, tokens: Tensor, dtype: torch.dtype, tp=None) -> Tensor:
    """The table cast to ``dtype``, then its rows: the reference's order, so
    the rows' cotangents sum in ``dtype`` before the cast back. With ``tp``
    this rank holds a slice of the vocabulary (``tensor_parallel.vocab_embed``)."""
    if tp is not None:
        return tensor_parallel.vocab_embed(tp, p["tok_embed"], tokens, dtype)
    return p["tok_embed"].to(dtype)[tokens.long()]


def lm_logits(p, x: Tensor, dtype: torch.dtype) -> Tensor:
    w = p["lm_head"] if "lm_head" in p else p["tok_embed"].T
    return x @ w.to(dtype)


class _Remat(torch.autograd.Function):
    """``run(*tensors) -> tuple of tensors``, saving only the input tensors;
    the backward recomputes ``run`` under ``torch.func.vjp``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(run, *inputs):
        return run(*inputs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.run = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *cotangents):
        inputs = ctx.saved_tensors
        wrt = [i for i, need in enumerate(ctx.needs_input_grad[1:]) if need]

        def run_wrt(*diff):
            args = list(inputs)
            for i, t in zip(wrt, diff):
                args[i] = t
            return ctx.run(*args)

        outputs, vjp_fn = torch.func.vjp(run_wrt, *(inputs[i] for i in wrt))
        # an output whose cotangent is None (unused) counts as zero
        cts = tuple(torch.zeros_like(o) if c is None else c
                    for o, c in zip(outputs, cotangents))
        grads = [None] * len(inputs)
        # detached (see the module docstring); the backward still runs in the
        # caller's grad mode, so its kernels are the plain pass's (run under
        # no_grad, the batched pass's gradients were not bitwise the plain ones)
        for i, g in zip(wrt, vjp_fn(cts)):
            grads[i] = g.detach()
        return (None, *grads)


def remat(fn: Callable) -> Callable:
    """``fn``, rematerialised: the port of ``jax.checkpoint``.

    ``fn`` takes trees (dicts and lists of tensors, tensors, other values)
    and returns a tensor or a dict or list of tensors. The call saves only
    the tensors among its arguments; the backward runs ``fn`` on them again
    and returns the cotangent of each that needs one (integer tensors such
    as positions need none). The values and gradients are those of ``fn``
    itself: the same ops run on the same inputs."""

    def call(*args):
        leaves = tree.leaves(list(args))
        where = [i for i, a in enumerate(leaves) if isinstance(a, Tensor)]
        others = [None if isinstance(a, Tensor) else a for a in leaves]
        like = tree.tree_map(lambda _: None, list(args))  # the structure, no tensor kept
        shape = []

        def run(*tensors):
            full = list(others)
            for i, t in zip(where, tensors):
                full[i] = t
            out = fn(*tree.unflatten(like, full))
            shape[:] = [tree.tree_map(lambda _: None, out)]
            return tuple(tree.leaves(out))

        outs = _Remat.apply(run, *(leaves[i] for i in where))
        return tree.unflatten(shape[0], list(outs))

    return call


_remat = remat  # chunked_xent's keyword shadows the name


def chunked_xent(p, h: Tensor, labels: Tensor, mask: Tensor, chunk: int, dtype: torch.dtype,
                 remat: bool = True, tp=None) -> Tensor:
    """Mean token cross-entropy over sequence chunks of ``chunk`` positions,
    so only (B, chunk, V) logits exist at a time. Divides by sum(mask). The
    logits are computed in ``dtype`` and cast to fp32 for the softmax.

    With ``remat`` (the reference's ``jax.checkpoint`` of the chunk body)
    the backward recomputes each chunk's logits, so it too holds one
    chunk's at a time; without it autograd keeps every chunk's.

    With ``tp`` the head's vocabulary is split over the model group
    (``tensor_parallel.vocab_xent``): ``h`` goes through ``copy_to_model``
    once, before the chunks."""
    S = h.shape[1]
    chunk = min(chunk, S)
    tied = "lm_head" not in p
    head = p["tok_embed"] if tied else p["lm_head"]
    if tp is not None:
        h = tp.copy(h)

    def body(w, hx, lx, mx):
        logits = (hx @ (w.T if tied else w).to(dtype)).to(torch.float32)
        if tp is not None:
            return torch.sum(tensor_parallel.vocab_xent(tp, logits, lx) * mx)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lx[..., None].long())[..., 0]
        return torch.sum((logz - gold) * mx)

    step = _remat(body) if remat else body
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        total = total + step(head, h[:, sl], labels[:, sl], mask[:, sl])
    return total / torch.clamp(torch.sum(mask), min=1.0)
