"""mandalorion_tpu — a long-read RNA-seq isoform identification and
quantification engine in JAX.

A from-scratch re-design of the Mandalorion APDFQ pipeline
(reference: velociroger-pb/Mandalorion, `Mando.py:160-171`) with batched
device routes for its hot loops:

- ``align``    — splice-aware long-read aligner (minimizer seed → chain →
                 banded affine-gap fill) replacing minimap2; the chain and
                 banded DPs run batched on the accelerator (plain JAX).
- ``poa``      — batched partial-order-alignment consensus replacing abPOA.
- ``core``     — the algorithmic heart (splice-site/TSS/polyA peak calling,
                 read→isoform grouping, isoform filtering, gene grouping,
                 quantification) expressed as vectorized segment ops.
- ``io``       — fastx / PSL / GTF / SAM / BED readers and writers.
- ``pipeline`` — APDFQ stage orchestration with the reference's
                 stage-artifact contract (tmp/ files as resume points).
- ``parallel`` — `jax.sharding.Mesh` based multi-device / multi-host scaling:
                 reads data-parallel, loci sharded, quant merged via psum.
- ``utils``    — satellite tools (polyA trimming, TPM conversion, LRGASP
                 export, HLA typing, SNP phasing).
"""

__version__ = "0.1.0"

from mandalorion_tpu.config import PipelineConfig  # noqa: F401
