"""jtk_tpu_torch — the assembler on PyTorch and CUDA (NVIDIA H100).

A second package beside ``jtk_tpu`` with the same layout, so every module
has a counterpart there:

  * ``ops``       — banded edit DP (K3), banded pair-HMM tables (K1),
                    modification table, polishing and MCMC clustering; the
                    hand-written CUDA kernels live in ``csrc/``.
  * ``mapper``    — seed-chain-extend read->chunk mapper.
  * ``datamodel`` — the serialized ``DataSet`` (same JSON ABI).
  * ``stages``    — pipeline stages, each DataSet -> DataSet.
  * ``graph``     — host-side graph algorithms.
  * ``io``        — simulation, FASTA/GFA/SAM, assembly evaluation.

Device work runs on the device of :mod:`jtk_tpu_torch.runtime` ("cuda"
unless the caller asks for the CPU); there is no silent CPU fallback.
"""

__version__ = "0.1.0"
