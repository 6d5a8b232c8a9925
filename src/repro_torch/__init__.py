"""repro_torch — the BWA-MEM reproduction on PyTorch and CUDA.

A second package beside ``repro`` (the JAX/Pallas reference).  It runs
single-end ``mem`` on an NVIDIA H100: the FM-index occupancy count (eta32
and eta128 bucket layouts) and banded Smith-Waterman extension are
hand-written CUDA kernels (``kernels/csrc``), and the rest of the
pipeline is the reference's numpy decision logic, kept as a copy here so
that this package imports neither JAX nor ``repro``.

Entry points: ``repro_torch.api.Aligner`` and ``python -m
repro_torch.cli {index,mem}``.  Both run on the card unless the caller
asks for ``device="cpu"``; without a CUDA device they raise.
"""
