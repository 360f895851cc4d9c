"""PyTorch + CUDA port of the ScaleCom reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``configs``, ``data``, ``core``, ``kernels``, ``backends``,
``models``, ``optim``, ``training``, ``launch``) with PyTorch inside. It
imports ``torch`` and never ``jax`` or anything of ``repro``.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; the ScaleCom reduce's select, EF-update and scatter run as
hand-written CUDA kernels (``repro_torch.kernels``) built from
``csrc/`` at first use. Train with ``python -m repro_torch.launch.train``.
"""

__all__ = ["__version__"]

__version__ = "0.1.0"
