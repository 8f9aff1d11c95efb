"""The port's sparselint certifies the certifier: deliberately broken plans,
steps and patterns must give exactly the expected codes, the shipped tree
none, and the pattern side must agree with the JAX package's."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.analysis import pattern_pass as ref_pattern_pass
from repro.core import block_pattern as ref_bp
from repro_torch.analysis import dispatch_pass, grid_pass, lint, pattern_pass
from repro_torch.analysis.capture import capture_launch
from repro_torch.analysis.findings import Finding, Report, apply_suppressions
from repro_torch.core import block_pattern as bpm
from repro_torch.core.block_pattern import (fit_block_pattern,
                                            make_block_pattern,
                                            partition_pattern)
from repro_torch.kernels import csd_spmm, launch
from repro_torch.kernels.launch import Buffer, Launch, LaunchPlan


def _codes(findings):
    return sorted({f.code for f in findings})


# ---------------------------------------------------------------------------
# the CLI, once clean and once with --selftest-inject (shared by the tests
# of the shipped tree)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_reports(tmp_path_factory):
    out = {}
    for tag, extra in (("clean", []), ("inject", ["--selftest-inject"])):
        path = tmp_path_factory.mktemp("lint") / f"{tag}.json"
        rc = lint.main(["--device", "cpu", "--format", "json", "--output",
                        str(path)] + extra)
        out[tag] = (rc, json.loads(path.read_text()))
    return out


def test_cli_exit_codes(cli_reports):
    assert cli_reports["clean"][0] == 0, cli_reports["clean"][1]["findings"]
    assert cli_reports["inject"][0] == 1


def test_selftest_inject_gives_sl101_and_sl206_only(cli_reports):
    """The race-broken forward (TPU kernel #9's counterpart) trips SL101
    and the whole-slab upcast SL206; nothing else is unsuppressed."""
    rep = cli_reports["inject"][1]
    got = sorted((f["code"], f["subject"]) for f in rep["findings"]
                 if not f.get("suppressed"))
    assert got == [("SL101", grid_pass.INJECTED),
                   ("SL206", "quant_inject[selftest]")], got
    assert rep["errors"] == []


def test_shipped_tree_is_clean_on_every_pass(cli_reports):
    rep = cli_reports["clean"][1]
    assert rep["findings"] == [] and rep["errors"] == []
    grid = rep["covered"]["grid"]
    for want in ("csd_spmm_fwd_4d_relu", "csd_spmm_fwd_4d_gelu_preact",
                 "csd_spmm_fwd_4d_plain", "csd_spmm_fwd_5d_batched",
                 "csd_spmm_fwd_quant_4d", "csd_spmm_fwd_quant_5d_batched",
                 "csd_spmm_dx_4d", "csd_spmm_dx_5d_batched",
                 "csd_spmm_dw_4d_db", "csd_spmm_dw_5d_batched",
                 "flash_attention_fwd", "flash_attention_bwd",
                 "paged_decode_attention", "paged_decode_attention_quant",
                 "gemma3_4b/train/dx_gate_gelu", "granite/decode/fwd_up",
                 "gemma3_4b/train/flash_bwd_local",
                 "granite/decode/paged_quant"):
        assert want in grid, want
        assert sum(rep["cost"][want]["ctas"]) > 1
    # five steps (paged prefill and decode, int8 and not, training) of each
    # of the eight token-input configs, and the dense-cache loop's prefill
    # and decode and the training step of the encoder-decoder and the
    # stub-frontend LM
    assert len(rep["covered"]["dispatch"]) == 46
    for arch in ("seamless_m4t_medium", "llava_next_34b"):
        for step in ("dense_loop[prefill]", "dense_loop[decode]",
                     "train_step"):
            assert f"{arch}:smoke:{step}" in rep["covered"]["dispatch"]
    assert "zamba2_1p2b:smoke:paged_step_int8[decode]" \
        in rep["covered"]["dispatch"]
    assert "deepseek_moe_16b:smoke:train_step" in rep["covered"]["dispatch"]
    assert any(s.startswith("granite_moe_1b_a400m:full")
               for s in rep["covered"]["pattern"])


# ---------------------------------------------------------------------------
# Pass 1: launch plans
# ---------------------------------------------------------------------------


def _manual_plan(write_rows=lambda c: (2 * c[:, 0], 2 * c[:, 0] + 2),
                 read_rows=lambda c: (2 * c[:, 0], 2 * c[:, 0] + 2),
                 grid=(2, 1, 1), smem=1024, tiles=(("rows", 4, 2, False),),
                 epilogue=True, slots=None):
    """One launch of ``grid`` CTAs over a (4, 10) input and output: CTA x
    stores output rows ``write_rows`` and loads input rows ``read_rows``."""
    def box(name, rows, c):
        n = len(c)
        return launch._box(name, n, rows, (0, 10))
    ln = Launch(
        kernel="synthetic", grid=grid, threads=128, smem=smem,
        writes=lambda c: [box("out", write_rows(c), c)],
        reads=lambda c, p: [box("in", read_rows(c), c)],
        fan_in=1, fan_in_axis="loop",
        slots=slots or (lambda c: (np.zeros(len(c), np.int64),
                                   np.ones(len(c), np.int64))),
        epilogue=epilogue, tiles=tiles)
    return LaunchPlan("synthetic", {"in": Buffer((4, 10), 4, "in"),
                                    "out": Buffer((4, 10), 4, "out")}, (ln,))


def test_hand_built_clean_plan():
    findings, cost = grid_pass.analyze_plan(_manual_plan(), "ok")
    assert findings == []
    assert cost["ctas"] == [2]
    assert cost["global_bytes_read"] == cost["global_bytes_written"] == 160


def test_two_writers_and_holes_flag_sl101():
    # both CTAs store rows 0:2: aliased, and rows 2:4 stay unwritten
    plan = _manual_plan(write_rows=lambda c: (0 * c[:, 0], 0 * c[:, 0] + 2))
    findings, _ = grid_pass.analyze_plan(plan, "race")
    assert _codes(findings) == ["SL101"]
    assert any("written by 2 CTAs" in f.message for f in findings)
    assert any("written by no CTA" in f.message for f in findings)


def test_injected_aliasing_kernel_flags_sl101():
    """The race-broken csd_spmm_fwd (fan-in slots split over CTAs that all
    store into y) must produce SL101 and nothing else."""
    case = grid_pass.injected_alias_case()
    plan = case.build()
    assert plan.launches[0].grid == (8, 4, 2)
    findings, _ = grid_pass.analyze_plan(plan, case.name)
    assert _codes(findings) == ["SL101"], findings


def test_non_dividing_unmasked_tile_flags_sl102():
    plan = _manual_plan(tiles=(("cols", 10, 3, False), ("M", 10, 3, True)))
    findings, _ = grid_pass.analyze_plan(plan, "tile")
    assert _codes(findings) == ["SL102"], findings
    assert len(findings) == 1  # the masked M tail is fine


def test_shared_memory_budget_flags_sl104():
    findings, _ = grid_pass.analyze_plan(_manual_plan(smem=2048), "smem",
                                         smem_budget=1024)
    assert _codes(findings) == ["SL104"], findings
    findings, _ = grid_pass.analyze_plan(
        _manual_plan(smem=launch.SMEM_OPTIN + 16), "smem")
    assert _codes(findings) == ["SL104"], findings


def test_out_of_range_read_flags_sl105():
    plan = _manual_plan(read_rows=lambda c: (c[:, 0] + 3, c[:, 0] + 5))
    findings, _ = grid_pass.analyze_plan(plan, "oob")
    assert _codes(findings) == ["SL105"], findings


def test_corrupt_block_idx_through_the_wrapper_flags_sl105():
    """A pattern entry past the left blocks makes the captured forward read
    x outside its columns."""
    bp = grid_pass._demo_pattern()
    idx = np.asarray(bp.block_idx).copy()
    idx[1, 0] = bp.n_lb + 3
    plan = capture_launch(
        csd_spmm.csd_spmm_fwd_cuda,
        torch.empty((256, bp.n_in), device="meta"),
        torch.empty((bp.n_rb, bp.d_in_b, 128, 128), device="meta"),
        torch.as_tensor(idx, dtype=torch.int32))
    findings, _ = grid_pass.analyze_plan(plan, "corrupt")
    assert _codes(findings) == ["SL105"], findings
    assert "x" in findings[0].detail["buffer"]


def _split_fwd_plan():
    """The demo forward at M 256 for 132 SMs: two fan-in splits, then the
    ordered reduce."""
    return grid_pass.demo_cases()[0].build()


def test_epilogue_in_a_split_cta_flags_sl103():
    plan = _split_fwd_plan()
    assert plan.n_splits == 2 and len(plan.launches) == 2
    split, reduce = plan.launches
    bad = dataclasses.replace(plan, launches=(
        dataclasses.replace(split, epilogue=True), reduce))
    findings, _ = grid_pass.analyze_plan(bad, "epilogue")
    assert _codes(findings) == ["SL103"], findings
    assert "fan-in slots [0, 1) of 2" in findings[0].message
    # a reduce launch that does not finish y: the epilogue never fires
    bad = dataclasses.replace(plan, launches=(
        split, dataclasses.replace(reduce, epilogue=False)))
    findings, _ = grid_pass.analyze_plan(bad, "no epilogue")
    assert _codes(findings) == ["SL103"], findings


def test_reading_unwritten_scratch_flags_sl101():
    plan = _split_fwd_plan()
    split, reduce = plan.launches
    findings, _ = grid_pass.analyze_plan(
        dataclasses.replace(plan, launches=(reduce,)), "no split")
    assert "SL101" in _codes(findings)
    assert any("no earlier launch wrote" in f.message for f in findings)


def test_capture_records_real_launch():
    """capture_launch sees the grid and split count the real wrapper plans
    for the SM count asked for, and the reads follow the pattern."""
    bp = grid_pass._demo_pattern()
    args = (torch.empty((256, bp.n_in), device="meta"),
            torch.empty((bp.n_rb, bp.d_in_b, 128, 128), device="meta"),
            torch.as_tensor(bp.block_idx, dtype=torch.int32))
    plan = capture_launch(csd_spmm.csd_spmm_fwd_cuda, *args, n_sm=132)
    assert plan.n_splits == launch.split_count(256, bp.n_out, bp.d_in_b, 132)
    assert plan.n_splits == 2
    assert [ln.kernel for ln in plan.launches] == ["csd_spmm_fwd_kernel",
                                                   "reduce_splits_kernel"]
    assert plan.launches[0].grid == (bp.n_out // 64, 256 // 64, 2)
    assert plan.args == dict(E=1, M=256, n_rb=bp.n_rb, bR=128, n_splits=2,
                             n_sm=132, tile_n=0, dtype=0)
    # few SMs: the output tiles alone fill them, no split
    small = capture_launch(csd_spmm.csd_spmm_fwd_cuda, *args, n_sm=4)
    assert small.n_splits == 1 and len(small.launches) == 1
    # CTA (0, 0, 0) loads x columns of block_idx[0, 0]
    reads = plan.launches[0].reads(np.zeros((1, 3), np.int64),
                                   plan.pattern_arrays())
    x = next(a for a in reads if a.buffer == "x")
    lb = int(bp.block_idx[0, 0])
    assert x.lo[0].tolist() == [0, lb * 128]
    assert x.hi[0].tolist() == [64, lb * 128 + 128]
    # the hooks are restored
    assert launch.run.__name__ == "run"
    with pytest.raises(ValueError, match="CUDA tensor"):
        csd_spmm.csd_spmm_fwd_cuda(torch.zeros((4, bp.n_in)),
                                   torch.zeros((4, 2, 128, 128)),
                                   args[2])


def test_split_counts_are_the_h100s():
    """split_count takes the SM count from its caller, so the plans of the
    card's shapes are reproducible off the card: the splits chip_smoke.py
    records for the H100's 132 SMs."""
    assert launch.split_count(4, 2560, 32, 132) == 7       # gemma3 down
    assert launch.split_count(4, 10240, 5, 132) == 2       # gemma3 up/gate
    assert launch.split_count(4, 512, 4, 132, 32) == 2     # granite up/gate
    assert launch.split_count(4096, 10240, 5, 132) == 1    # training


# ---------------------------------------------------------------------------
# Pass 2: dispatch lint of the steps
# ---------------------------------------------------------------------------


def _lint_step(step, shapes=frozenset()):
    ops, sync = dispatch_pass.trace(step, torch.device("cpu"))
    assert sync is None
    return dispatch_pass.lint_ops(ops, "step", shapes)


def test_host_syncs_flag_sl201():
    t = torch.arange(6)
    assert _codes(_lint_step(lambda: t.sum().item())) == ["SL201"]
    assert _codes(_lint_step(lambda: t[t > 2])) == ["SL201"]  # bool mask
    assert _codes(_lint_step(lambda: torch.nonzero(t))) == ["SL201"]
    assert _codes(_lint_step(lambda: bool(t.any()))) == ["SL201"]
    assert _codes(_lint_step(lambda: torch.bincount(t))) == ["SL201"]
    assert _lint_step(lambda: (t * 2).sum()) == []


def test_wide_dtype_flags_sl203():
    x = torch.ones(4)
    assert _codes(_lint_step(lambda: x.double() * 2)) == ["SL203"]
    assert _lint_step(lambda: x.float() * 2) == []


def test_whole_slab_dequant_flags_sl206():
    """The self-test junction (whole-slab upcast before csd_matmul) trips
    SL206; the shipped int8 junction on the same slab, 4-D and 5-D, stays
    clean (the plain version dequantizes one slot at a time)."""
    from repro_torch.core.quant import quantize_slab
    from repro_torch.kernels.ops import csd_matmul
    step, shapes = dispatch_pass.quant_inject_step(torch.device("cpu"))
    assert _codes(_lint_step(step, shapes)) == ["SL206"]
    bp = grid_pass._demo_pattern()
    idx = torch.as_tensor(bp.block_idx, dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    for lead in ((), (3,)):
        w, s = quantize_slab(torch.randn(
            lead + (bp.n_rb, bp.d_in_b, 128, 128), generator=g))
        x = torch.randn(lead + (4, bp.n_in), generator=g)
        assert _lint_step(lambda: csd_matmul(x, w, idx, w_scale=s),
                          dispatch_pass.int8_shapes(w)) == []


def test_moe_counts_have_no_host_sync():
    """``_counts`` (the MoE's bincount) is the sum of a comparison: the
    same counts as ``bincount``, and no ``.item()`` on any device (the
    lint found ``one_hot``'s range check on the CPU)."""
    from repro_torch.nn.ffn import _counts
    ids = torch.tensor([3, 0, 3, 5, 1, 3])
    assert _counts(ids, 7).tolist() == torch.bincount(
        ids, minlength=7).tolist()
    assert _lint_step(lambda: _counts(ids, 7)) == []


# ---------------------------------------------------------------------------
# Pass 3: pattern invariants, and parity with the JAX package
# ---------------------------------------------------------------------------


def _demo():
    return make_block_pattern(512, 512, 0.5, block_in=128, block_out=128)


def _broken_patterns():
    """(name, pattern) of deliberately broken variants of the demo."""
    bp = _demo()
    idx = np.asarray(bp.block_idx).copy()
    dup = idx.copy()
    dup[0, 1] = dup[0, 0]
    oob = idx.copy()
    oob[0, 0] = bp.n_lb + 3
    hole = idx.copy()
    hole[hole == 3] = 0  # left block 3 feeds nothing (and 0 twice)
    oi = np.asarray(bp.out_idx).copy()
    osl = np.asarray(bp.out_slot)
    taken = {(int(r), int(s)) for r, s in zip(oi[0], osl[0])}
    s0 = int(osl[0, 0])
    oi[0, 0] = next(r for r in range(bp.n_rb) if (r, s0) not in taken)
    return [("ok", bp),
            ("dup", dataclasses.replace(bp, block_idx=dup)),
            ("oob", dataclasses.replace(bp, block_idx=oob)),
            ("hole", dataclasses.replace(bp, block_idx=hole)),
            ("mismatch", dataclasses.replace(bp, out_idx=oi))]


def _as_ref(bp):
    """The same pattern as the JAX package's BlockPattern."""
    return ref_bp.BlockPattern(
        n_in=bp.n_in, n_out=bp.n_out, block_in=bp.block_in,
        block_out=bp.block_out, block_idx=np.asarray(bp.block_idx),
        out_idx=np.asarray(bp.out_idx), out_slot=np.asarray(bp.out_slot),
        out_valid=bp.out_valid, meta=dict(bp.meta))


def _keys(findings):
    return [(f.code, f.subject) for f in findings]


@pytest.mark.parametrize("name,want", [
    ("ok", []), ("dup", ["SL301", "SL303"]), ("oob", ["SL304"]),
    ("hole", ["SL302", "SL303"]), ("mismatch", ["SL303"])])
def test_check_pattern_codes_match_the_reference(name, want):
    bp = dict(_broken_patterns())[name]
    got = pattern_pass.check_pattern(bp, name)
    assert _codes(got) == want, got
    assert _keys(got) == _keys(ref_pattern_pass.check_pattern(_as_ref(bp),
                                                              name))


def test_check_partition_matches_the_reference():
    part = partition_pattern(_demo(), 2)
    ref_part = ref_bp.partition_pattern(_as_ref(_demo()), 2)
    assert pattern_pass.check_partition(part, "p") == []
    ov = np.asarray(part.out_valid).copy()
    ov[1, 0, :] = 0  # drop one shard's slots: unbalanced work
    got = pattern_pass.check_partition(
        dataclasses.replace(part, out_valid=ov), "unbal")
    ref = ref_pattern_pass.check_partition(
        dataclasses.replace(ref_part, out_valid=ov), "unbal")
    assert "SL305" in _codes(got)
    assert _keys(got) == _keys(ref)


def test_partition_pattern_bit_equal_to_the_reference():
    """On every smoke and full-width junction pattern of both configs, and
    every mesh size that divides it."""
    pats = {}
    for subject, bp in pattern_pass.collect_patterns():
        pats.setdefault((bp.n_in, bp.n_out, bp.block_in, bp.block_out,
                         np.asarray(bp.block_idx).tobytes()), (subject, bp))
    assert any(":full" in s for s, _ in pats.values())
    n = 0
    for subject, bp in pats.values():
        for k in (1, 2, 4, 8):
            if not bpm.can_partition(bp, k):
                assert not ref_bp.can_partition(_as_ref(bp), k)
                continue
            got = partition_pattern(bp, k)
            ref = ref_bp.partition_pattern(_as_ref(bp), k)
            for field in ("row_assign", "perm", "inv_perm", "idx",
                          "out_idx", "out_slot", "out_valid"):
                a, b = getattr(got, field), np.asarray(getattr(ref, field))
                assert a.dtype == b.dtype and np.array_equal(a, b), \
                    (subject, k, field)
            for s, r in zip(got.shards, ref.shards):
                for field in ("block_idx", "out_idx", "out_slot",
                              "out_valid"):
                    assert np.array_equal(getattr(s, field),
                                          getattr(r, field))
                assert s.n_out == r.n_out
            n += 1
    assert n >= 4


def test_fit_block_pattern_debug_certifies(monkeypatch):
    from repro_torch.nn.common import SparsityConfig
    sp = SparsityConfig(enabled=True, block_in=128, block_out=128)
    assert fit_block_pattern(512, 512, 0.5, sp, debug=True) is not None
    broken = dict(_broken_patterns())["dup"]
    monkeypatch.setattr(bpm, "make_block_pattern", lambda *a, **k: broken)
    with pytest.raises(ValueError, match="SL301"):
        fit_block_pattern(512, 512, 0.5, sp, debug=True)
    assert fit_block_pattern(512, 512, 0.5, sp) is broken  # off by default


def test_pattern_debug_env_flag(monkeypatch):
    monkeypatch.setenv("REPRO_PATTERN_DEBUG", "1")
    assert partition_pattern(_demo(), 2).n_shards == 2  # must not raise
    broken = dict(_broken_patterns())["dup"]
    with pytest.raises(ValueError, match="SL301"):
        partition_pattern(broken, 2)
    assert partition_pattern(broken, 2, debug=False).n_shards == 2


# ---------------------------------------------------------------------------
# report + suppressions
# ---------------------------------------------------------------------------


def test_suppressions_mark_but_keep_findings():
    fs = [Finding("SL101", "kern_a", "boom"),
          Finding("SL101", "kern_b", "boom"),
          Finding("SL104", "kern_a", "boom")]
    out = apply_suppressions(fs, [("SL101", "kern_a", "known issue")])
    assert out[0].suppressed and out[0].justification == "known issue"
    assert not out[1].suppressed and not out[2].suppressed
    r = Report(findings=out)
    assert len(r.unsuppressed()) == 2
    assert "suppressed" in r.to_text()
    assert r.to_dict()["n_unsuppressed"] == 2
    from repro_torch.analysis.suppressions import SUPPRESSIONS
    assert all(len(s) == 3 and s[2] for s in SUPPRESSIONS)
