"""sparselint for the port — static certifier of the CUDA launches, the
steps and the sparsity patterns (the port's counterpart of
``repro.analysis``).

Three passes (``python -m repro_torch.analysis.lint`` is the CLI):

* ``grid_pass``     — SL1xx: CUDA launch plans (races, divisibility,
  epilogue, shared memory, bounds)
* ``dispatch_pass`` — SL2xx: host syncs, wide dtypes and int8 upcasts in
  the serving and training steps
* ``pattern_pass``  — SL3xx: BlockPattern / partition invariants

Import the pass modules explicitly (``from repro_torch.analysis import
grid_pass``).
"""

from .findings import Finding, Report, Suppression, apply_suppressions

__all__ = ["Finding", "Report", "Suppression", "apply_suppressions"]
