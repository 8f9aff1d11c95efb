"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

It mirrors ``src/repro`` module for module (``repro_torch.<path>`` is the
counterpart of ``repro.<path>``) and imports neither JAX nor ``repro``.
Every TPU kernel on a ported path has a hand-written CUDA kernel under
``kernels/csrc`` with a plain PyTorch version beside it; a CPU tensor runs
the plain version, a CUDA tensor the kernel.

Ported so far: serving a decoder-only LM (gemma3_4b) through the paged
serving engine, with the ``csd_spmm_fwd`` and ``paged_decode_attention``
kernels; and training it (``train.Trainer``, ``launch.train``) with the
junction's forward, backward-data and backward-weights kernels
(``csd_spmm_fwd``, ``csd_spmm_dx``, ``csd_spmm_dw``); and serving it in
int8 (``core.quant``, ``EngineConfig.quant``) with the int8 forward kernel
``csd_spmm_fwd_quant`` and paged decode over int8 pages; the same for
granite_moe_1b_a400m through the expert-batched kernels; full-sequence
attention through the flash-attention kernels; and sparselint
(``analysis``, ``python -m repro_torch.analysis.lint``), which certifies
the kernels' launch plans (``kernels.launch``), the serving and training
steps and the sparsity patterns, with TPU kernel #9's counterpart (the
race-broken forward of ``csrc/csd_spmm_fwd_injected_alias.cu``) as its
self-test; and the paper's own sparse MLP (``core.sparse_linear``,
``nn.mlp``, ``configs.paper_mlp``, ``core.storage``), whose small blocks
(and the smoke configurations' 16 x 16) run the small-block forms of the
junction kernels (``csrc/csd_spmm_small.cu``); and the rest of
single-device training: checkpoints (``train.checkpoint``), restart
(``train.fault_tolerance``, the CLI's restart loop), DiLoCo with int8
error-feedback compression (``optim.compression``) and the obs registry
(``obs``: metrics, spans, profiles, the JSONL dump).
"""
