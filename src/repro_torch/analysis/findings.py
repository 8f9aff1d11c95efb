"""Finding model shared by every sparselint pass of the port (port of
``repro.analysis.findings``).

Each finding carries a stable *code* (``SL1xx`` grid pass, ``SL2xx``
dispatch pass, ``SL3xx`` pattern pass), a *subject* (the kernel case /
config / pattern it was found in) and a human message. Codes are the unit
of suppression: a suppression entry names a code plus a subject substring
and a justification, and suppressed findings stay in the report (marked)
but do not fail the lint — the same contract as the FPGA flow the paper's
companion hardware uses, where every waived timing/bank check must carry a
sign-off note.

Code map (kept in sync with README.md "Static certification on the port"):

=====  =====================================================================
SL101  output aliasing: an output element written by no CTA or by several
       CTAs of one launch (CTAs run concurrently, in any order)
SL102  a tile does not divide the extent it cuts, and the kernel does not
       mask that edge
SL103  fused epilogue does not fire exactly once per output element, in a
       CTA (or reduce/merge launch) that covers the whole fan-in
SL104  per-CTA shared memory over budget
SL105  a read or write outside its tensor (corrupt pattern / page table)
SL201  host sync inside a step (item, nonzero, is_nonzero, device -> CPU copy)
SL202  not ported: donation (a second copy of a large parameter, optimizer
       or KV tensor); comes with the CUDA-graph work
SL203  unintended wide-dtype promotion (float64/complex128) in a step
SL204  not ported: baked constants (a large tensor captured in a CUDA
       graph); comes with the CUDA-graph work
SL205  not ported: shard_map collectives; comes with multi-device (slice 8)
SL206  whole int8 slab / KV pool upcast to a float dtype inside a step
SL301  duplicate edge: one left block feeds the same right block twice
SL302  coverage hole: a left/right block with no surviving edges
SL303  scatter form (out_idx/out_slot/out_valid) disagrees with gather form
SL304  degree bound violation vs the paper's structured-sparsity constraint
SL305  per-shard slot counts unbalanced (SPMD shards would diverge in work)
=====  =====================================================================
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

# (code, subject substring, justification) entries mark findings as waived.
Suppression = Tuple[str, str, str]


@dataclasses.dataclass
class Finding:
    code: str           # e.g. "SL101"
    subject: str        # kernel case / config / pattern identifier
    message: str
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)
    suppressed: bool = False
    justification: Optional[str] = None

    def key(self) -> str:
        return f"{self.code}:{self.subject}"

    def to_dict(self) -> Dict[str, Any]:
        d = {"code": self.code, "subject": self.subject,
             "message": self.message, "detail": self.detail}
        if self.suppressed:
            d["suppressed"] = True
            d["justification"] = self.justification
        return d


def apply_suppressions(findings: Sequence[Finding],
                       suppressions: Sequence[Suppression]) -> List[Finding]:
    """Mark findings matched by a (code, subject-substring) entry."""
    out = []
    for f in findings:
        for code, subj, why in suppressions:
            if f.code == code and subj in f.subject:
                f = dataclasses.replace(f, suppressed=True,
                                        justification=why)
                break
        out.append(f)
    return out


@dataclasses.dataclass
class Report:
    """Full lint run result: findings plus per-kernel cost estimates."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    # kernel case name -> cost dict (grid, CTAs, shared memory per CTA,
    # bytes the plan streams from and to global memory)
    cost: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    # pass name -> list of subjects covered (so "no findings" is
    # distinguishable from "never ran")
    covered: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    errors: List[str] = dataclasses.field(default_factory=list)
    # free-form evidence lines (the on-card launch of the injected kernel)
    notes: List[str] = dataclasses.field(default_factory=list)
    # pass name -> wall seconds it took
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    def extend(self, findings: Sequence[Finding]) -> None:
        self.findings.extend(findings)

    def unsuppressed(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "findings": [f.to_dict() for f in self.findings],
            "n_findings": len(self.findings),
            "n_unsuppressed": len(self.unsuppressed()),
            "cost": self.cost,
            "covered": self.covered,
            "errors": self.errors,
            "notes": self.notes,
            "seconds": self.seconds,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)

    def to_text(self) -> str:
        lines = []
        for f in self.findings:
            tag = " [suppressed: %s]" % f.justification if f.suppressed \
                else ""
            lines.append(f"{f.code} {f.subject}: {f.message}{tag}")
            for k, v in f.detail.items():
                lines.append(f"    {k}: {v}")
        for name, cost in sorted(self.cost.items()):
            lines.append(f"cost {name}: " + ", ".join(
                f"{k}={v}" for k, v in cost.items()))
        for p, subjects in sorted(self.covered.items()):
            lines.append(f"covered[{p}]: {len(subjects)} subjects")
        lines.extend(f"note: {n}" for n in self.notes)
        if self.seconds:
            lines.append("seconds: " + ", ".join(
                f"{k} {v:.2f}" for k, v in self.seconds.items()))
        for e in self.errors:
            lines.append(f"error: {e}")
        n_sup = len(self.findings) - len(self.unsuppressed())
        lines.append(
            f"sparselint: {len(self.unsuppressed())} finding(s), "
            f"{n_sup} suppressed")
        return "\n".join(lines)
