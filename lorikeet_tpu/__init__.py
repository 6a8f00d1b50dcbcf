"""lorikeet_tpu — a GPU-accelerated strain-level metagenomic variant-analysis framework.

A from-scratch JAX/XLA re-design of the capabilities of rhysnewell/Lorikeet
(GATK-HaplotypeCaller-style local re-assembly variant calling plus strain-resolution
machinery):

- The pair-HMM forward runs on an NVIDIA GPU as a CUDA kernel called through
  jax.ffi (native/pairhmm_cuda.cu), beside an exact f64 C++ host kernel;
  lorikeet_tpu.device picks the route from the JAX backend.
- Ragged genomic work (regions, reads, haplotypes) is bucketed into padded
  batches so each compiled shape is reused.
- Host code (BAM/FASTA/VCF I/O, graph assembly) feeds the device via padded arrays.
- Several devices: pair-HMM dispatches round-robin over a jax.sharding Mesh, and
  activity profiling shards the position axis with shard_map.

Layer map mirrors the reference survey (SURVEY.md §1): utils → io → ops (kernels)
→ assembly → calling → strain → cli.
"""

__version__ = "0.1.0"
