"""Serving driver: prefill a batch of prompts on an architecture's smoke
variant (``--arch``, one of ``repro_torch.configs.registry.ARCHS``) and
decode greedily through the KV-cache / recurrent-state serve path.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --batch 4 \
        --prompt-len 64 --gen 32 [--device cuda|cpu]

The port of ``repro.launch.serve``. It runs on the CUDA card by default and
raises if there is none; ``--device cpu`` runs on the CPU. An unknown
``--arch`` exits naming the registry's ids (the reference raises a bare
``KeyError`` there).
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.training.serve import build_serve_fns

__all__ = ["generate", "main"]


def generate(prefill_fn, decode_fn, params, batch, ctx: int, gen: int,
             sync: Callable[[], None] = lambda: None) -> Tuple[torch.Tensor, float, float]:
    """Greedy decoding: the prompt's prefill, then ``gen - 1`` decode steps
    from position ``ctx``. Returns the (B, gen) tokens on the model's device
    and the seconds of the prefill and of the decode steps, each ended by
    ``sync`` (the device's synchronize); nothing else waits for the device."""
    t0 = time.perf_counter()
    logits, state = prefill_fn(params, batch)
    tok = torch.argmax(logits, dim=-1)
    sync()
    t1 = time.perf_counter()
    out = [tok]
    for i in range(gen - 1):
        logits, state = decode_fn(params, state, tok, ctx + i)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    sync()
    return torch.stack(out, dim=1), t1 - t0, time.perf_counter() - t1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b",
                    help=f"architecture id; its SMOKE variant serves: {', '.join(registry.ARCHS)}")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.arch not in registry.ARCHS:
        raise SystemExit(f"unknown arch {args.arch}; choices: {list(registry.ARCHS)}")
    cfg = registry.smoke(args.arch)
    device = resolve_device(args.device)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(args.seed), device)

    src = SyntheticLM(cfg.vocab, seed=args.seed)
    prompts = src.sample(np.random.default_rng(args.seed), args.batch, args.prompt_len)
    batch = {"tokens": torch.from_numpy(prompts[:, : args.prompt_len]).to(device)}
    stub = torch.Generator().manual_seed(args.seed)
    if cfg.arch_type == "vlm":
        batch["vision"] = torch.randn((args.batch, cfg.vision_tokens, cfg.d_model),
                                      generator=stub).to(device)
    if cfg.is_encdec:
        batch["frames"] = torch.randn((args.batch, cfg.encoder_seq, cfg.d_model),
                                      generator=stub).to(device)

    ctx = args.prompt_len + (cfg.vision_tokens if cfg.arch_type == "vlm" else 0)
    prefill_fn, decode_fn = build_serve_fns(model, seq_len=ctx + args.gen)

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    tokens, t_prefill, t_decode = generate(prefill_fn, decode_fn, params, batch, ctx, args.gen,
                                           sync)
    gen = tokens.cpu().numpy()
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} gen={args.gen}")
    print(f"prefill: {t_prefill:.3f}s  decode: "
          f"{t_decode / max(args.gen - 1, 1) * 1e3:.2f} ms/token")
    print("generated token ids (first sequence):", gen[0][:16], "...")
    return gen


if __name__ == "__main__":
    main()
