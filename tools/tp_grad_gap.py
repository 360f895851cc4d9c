"""How far the tensor-parallel pass's per-worker gradients stand from the
unsplit pass's on the card, beside how far two batchings of the unsplit
pass stand from each other: the rounding that a ``TP_RUNS`` cell's
``rounding_of_max`` (``chip_smoke.py``) must cover.

An arch at full width, cut to ``layers`` layers (an encoder-decoder's
encoder too), fp32 compute, the initial parameters drawn from one CUDA
generator seed, 2 workers x 2 x 128 tokens of ``make_batches``. Two
spawned gloo processes on the one card run the split pass
(``per_worker_grads(tp=...)`` on a (1 data, 2 model) grid) on worker 0's
row and gather the named leaves' gradients to host memory; then this
process runs the unsplit pass on worker 0's row alone and in a batch of
both workers. For each leaf it prints the largest |gradient|, the largest
difference as a share of it, and the relative differences of the
elements below 1e-3 of the largest. Prints the card's name and power
limit first.

    python3 tools/tp_grad_gap.py recurrentgemma-2b 4
"""

import dataclasses
import datetime
import multiprocessing
import os
import subprocess
import sys
import tempfile

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, os.path.join(ROOT, "src"))
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

LEAVES = ("['lm_head']", "['tok_embed']", "['ln_final_scale']")


def setup(arch: str, layers: int):
    from repro_torch.configs import registry
    from repro_torch.data import make_batches, model_inputs
    from repro_torch.models import build_model

    cfg = registry.arch(arch)
    cfg = dataclasses.replace(cfg, n_layers=layers,
                              encoder_layers=layers if cfg.is_encdec else 0)
    model = build_model(cfg, compute_dtype="float32", loss_chunk=64)
    batch = next(make_batches(cfg.vocab, 2, 2, 128, seed=0, steps=1, **model_inputs(cfg)))
    return model, batch


def leaves_of(model) -> list:
    """``LEAVES`` and every leaf of the first layer that the model axis splits."""
    from repro_torch import tree

    paths = [p for p, _ in tree.flatten_with_path(model.abstract_params())]
    return [p for p in paths if p in LEAVES or p.endswith(("['rec_out']", "['rec_wa']",
                                                           "['cross_wk']", "['attn_wq']"))]


def report(name: str, got, want) -> None:
    d = (got.double() - want.double()).abs()
    top = float(want.abs().max())
    small = want.abs() < 1e-3 * top
    rel = d / want.double().abs().clamp_min(1e-30)
    tail = (f"; {int(small.sum()):,} elements below 1e-3 of it, their relative difference "
            f"median {float(rel[small].median()):.3e}" if bool(small.any()) else "")
    print(f"{name}: largest |g| {top:.4e}, largest difference {float(d.max()):.4e} "
          f"({float(d.max()) / top:.3e} of it){tail}", flush=True)


def rank_main(rank: int, store: str, arch: str, layers: int, conn) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.device import fp32_accumulation
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.training import train_step as ts

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=600))
    fp32_accumulation()
    model, batch = setup(arch, layers)
    mesh = make_test_mesh((1, 2))
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda", mesh=mesh)
    layout = ts._tp_layout(model.abstract_params(), model.logical_axes(), mesh)
    one = {k: torch.as_tensor(v[0:1], device="cuda") for k, v in batch.items()}
    loss, _, grads = ts.per_worker_grads(model, params, one, 1, tp=layout.axis)
    flat = dict(tree.flatten_with_path(grads))
    out = {"loss": float(loss), "grads": {}}
    for path in leaves_of(model):
        x = flat[path][0].to("cpu", copy=True)
        dim = next((d for d, a in enumerate(layout.specs[layout.paths.index(path)])
                    if a == "model"), None)
        if dim is not None:
            parts = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(parts, x)
            x = torch.cat(parts, dim)
        out["grads"][path] = x
    if rank == 0:
        conn.send(out)
    dist.barrier()
    dist.destroy_process_group()


def main(arch: str, layers: int) -> int:
    import torch

    from repro_torch import tree
    from repro_torch.device import fp32_accumulation
    from repro_torch.training import train_step as ts

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown card"
    print(card)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        recv, send = ctx.Pipe(duplex=False)
        procs = [ctx.Process(target=rank_main,
                             args=(r, os.path.join(tmp, "store"), arch, layers, send))
                 for r in range(2)]
        for p in procs:
            p.start()
        split = recv.recv() if recv.poll(900) else None
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
        if split is None or any(p.exitcode != 0 for p in procs):
            print("the split pass failed", file=sys.stderr)
            return 1
    fp32_accumulation()
    model, batch = setup(arch, layers)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    unsplit, losses = {}, {}
    for n in (1, 2):
        rows = {k: torch.as_tensor(v[:n], device="cuda") for k, v in batch.items()}
        loss, _, grads = ts.per_worker_grads(model, params, rows, n)
        losses[n] = float(loss)
        unsplit[n] = {p: x[0].to("cpu") for p, x in tree.flatten_with_path(grads)
                      if p in split["grads"]}
        del grads
    print(f"{arch} at {layers} layers, worker 0's loss: split {split['loss']!r}, unsplit "
          f"{losses[1]!r}; on {card}")
    for path, want in unsplit[1].items():
        report(f"{path} split against unsplit", split["grads"][path], want)
        report(f"{path} unsplit, 2 workers batched against 1", unsplit[2][path], want)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
