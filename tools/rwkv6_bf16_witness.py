"""RWKV-6 at full width in bf16: the reference's own prefill/decode
consistency and bf16-against-fp32 gap, beside the port's, on the CPU.

``chip_smoke.py``'s ``[serve:bf16]`` holds the port's rwkv6-3b at full
depth on the card: a decode step after a prefill of T tokens against the
prefill of T + 1, with bf16 parameters and compute. This script asks the
JAX package the same question at the same width (d 2560, 40 heads of 64,
d_ff 8960, vocab 65536) and at cut depths, from one draw of the reference's
weights (fp32, rounded to bf16), and runs the port on the same weights and
tokens. For each depth it prints, for the reference and for the port:

  * ``consistency``: the largest |decode logit - prefill logit| over the
    largest |prefill logit|;
  * ``gap``: the same bf16 weights computed in fp32 against bf16 compute,
    at the prefill of T + 1, over the same scale;

and the port's bf16 prefill logits against the reference's. XLA runs with
``--xla_allow_excess_precision=false``, so the reference rounds every bf16
op as PyTorch does (XLA's CPU otherwise keeps some bf16 intermediates in
fp32). Needs the JAX package and the port; runs on the CPU only.

    PYTHONPATH=src python tools/rwkv6_bf16_witness.py --depths 1,2,4,8
"""

import argparse
import dataclasses
import json
import os
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_allow_excess_precision=false").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

NAME = "rwkv6-3b"


def cut(params, depth: int):
    """The reference's parameters with each stacked block leaf's first ``depth`` layers."""
    return dict(params, blocks=jax.tree.map(lambda x: x[:depth], params["blocks"]))


def largest(a) -> float:
    return float(np.abs(np.asarray(a, np.float32)).max())


def diff(a, b) -> float:
    return largest(np.asarray(a, np.float32) - np.asarray(b, np.float32))


def reference(cfg, params, toks, T: int) -> dict:
    """The JAX package's bf16 logits: prefill of T + 1, decode after the
    prefill of T, and the prefill of T + 1 computed in fp32."""
    out = {}
    for dt in ("bfloat16", "float32"):
        m = jbuild(cfg, compute_dtype=dt, param_dtype="bfloat16")
        out[dt] = np.asarray(jax.jit(lambda p, t: m.prefill(p, {"tokens": t}, T + 8)[0])(
            params, toks).astype(jnp.float32))
    m = jbuild(cfg, compute_dtype="bfloat16", param_dtype="bfloat16")
    _, st = jax.jit(lambda p, t: m.prefill(p, {"tokens": t}, T + 8))(params, toks[:, :T])
    got, _ = jax.jit(m.decode_step)(params, st, toks[:, T], jnp.int32(T))
    out["decode"] = np.asarray(got.astype(jnp.float32))
    return out


@torch.no_grad()
def port(cfg, params, toks, T: int) -> dict:
    """The port's logits, as ``reference`` computes them."""
    p = params_from_jax(params, "cpu")
    t = torch.from_numpy(np.array(toks))
    out = {}
    for dt in ("bfloat16", "float32"):
        m = build_model(cfg, compute_dtype=dt, param_dtype="bfloat16")
        out[dt] = m.prefill(p, {"tokens": t}, T + 8)[0].float().numpy()
    m = build_model(cfg, compute_dtype="bfloat16", param_dtype="bfloat16")
    _, st = m.prefill(p, {"tokens": t[:, :T]}, T + 8)
    out["decode"] = m.decode_step(p, st, t[:, T], T)[0].float().numpy()
    return out


def measures(o: dict) -> dict:
    scale = largest(o["bfloat16"])
    return {"consistency": diff(o["decode"], o["bfloat16"]) / scale,
            "gap": diff(o["float32"], o["bfloat16"]) / scale, "scale": scale}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depths", default="1,2,4,8", help="comma-separated layer counts")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    depths = sorted(int(d) for d in args.depths.split(","))
    full = jregistry.arch(NAME)
    jcfg = dataclasses.replace(full, n_layers=depths[-1])
    t0 = time.perf_counter()
    params, _ = jbuild(jcfg, param_dtype="bfloat16").init(jax.random.PRNGKey(args.seed))
    T = args.prompt
    toks = jnp.asarray(np.random.default_rng(args.seed).integers(
        0, full.vocab, (args.batch, T + 1)).astype(np.int32))
    print(f"{NAME}: d {full.d_model}, d_ff {full.d_ff}, vocab {full.vocab}; weights drawn at "
          f"{depths[-1]} layers (fp32, rounded to bf16) in {time.perf_counter() - t0:.1f} s; "
          f"batch {args.batch}, prompt {T}; XLA_FLAGS={os.environ['XLA_FLAGS']}", flush=True)
    rows = []
    for depth in depths:
        t0 = time.perf_counter()
        p = cut(params, depth)
        ref = reference(dataclasses.replace(jcfg, n_layers=depth), p, toks, T)
        ours = port(dataclasses.replace(registry.arch(NAME), n_layers=depth), p, toks, T)
        row = {"depth": depth, "reference": measures(ref), "port": measures(ours),
               "port_vs_reference": diff(ours["bfloat16"], ref["bfloat16"])
               / largest(ref["bfloat16"])}
        rows.append(row)
        r, q = row["reference"], row["port"]
        print(f"depth {depth:2d}: consistency reference {r['consistency']:.3e} port "
              f"{q['consistency']:.3e}; bf16-fp32 gap reference {r['gap']:.3e} port "
              f"{q['gap']:.3e}; port bf16 against reference bf16 {row['port_vs_reference']:.3e} "
              f"(largest |logit| {r['scale']:.3f}); {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"arch": NAME, "batch": args.batch, "prompt": T, "rows": rows}))


if __name__ == "__main__":
    main()
