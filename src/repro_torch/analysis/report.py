"""The residue-codec table of ``repro.analysis.report``:

    python -m repro_torch.analysis.report --codecs [--codec-steps N] [--device cuda|cpu]

prints, for each residue codec of ``core.state.CODECS``, the per-step
encode o decode error of an EF-like accumulation and its drift against an
exact fp32 accumulator (``codec_roundtrip_error``, from the port's own
draws). It runs the codecs on the card, as the training path does, unless
``--device cpu`` asks for the CPU; without CUDA the default raises. The reference's other tables (compile, roofline and
gradient traffic of the dry-run over 512-device meshes) read XLA's lowering
and have no counterpart; without ``--codecs`` the module exits saying so.
"""

from __future__ import annotations

import argparse

from repro_torch.device import resolve_device

__all__ = ["codec_table", "main"]


def codec_table(steps: int = 5, device="cuda") -> str:
    """Residue-codec encode o decode health as a markdown table: the per-step
    roundtrip error must stay a contraction (< 1) and the accumulated drift
    bounded, the precondition ScaleCom's Theorem 1 places on the quantized
    EF memory. The codecs run on ``device`` (the card unless "cpu")."""
    from repro_torch.core.state import CODECS, codec_roundtrip_error

    out = [
        "| codec | worst step err | last step err | drift vs fp32 |",
        "|---|---:|---:|---:|",
    ]
    for name in CODECS:
        r = codec_roundtrip_error(name, steps=steps, device=device)
        out.append(f"| {name} | {r['worst_step']:.2e} | {r['last_step']:.2e} | "
                   f"{r['drift']:.2e} |")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.report")
    ap.add_argument("--codecs", action="store_true",
                    help="print the residue-codec roundtrip table")
    ap.add_argument("--codec-steps", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu (the plain CPU run)")
    args = ap.parse_args(argv)
    if not args.codecs:
        raise SystemExit("repro_torch.analysis.report: only --codecs has a port; the "
                         "reference's dry-run tables read XLA's lowering, which the port "
                         "has no counterpart of")
    device = resolve_device(args.device)
    print("## Residue codec roundtrip\n")
    print(codec_table(args.codec_steps, device))


if __name__ == "__main__":
    main()
