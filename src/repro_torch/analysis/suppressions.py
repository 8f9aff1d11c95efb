"""Checked-in suppression table for the port's sparselint (port of
``repro.analysis.suppressions``).

Every entry waives one finding class on one subject and MUST carry a
justification. Entries are ``(code, subject-substring, justification)``; a
finding is suppressed when its code matches exactly and the substring
occurs in its subject. The finding stays in the report, marked suppressed,
so waivers are visible in every run's output.

Add entries here (with a comment) rather than passing ``--no-suppress``
exceptions around; ``python -m repro_torch.analysis.lint`` reads exactly
this table.
"""
from __future__ import annotations

from typing import List

from .findings import Suppression

SUPPRESSIONS: List[Suppression] = []
