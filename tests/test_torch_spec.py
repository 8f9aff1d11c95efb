"""The port's speculative decode against the JAX package's: the prompt-lookup
drafts, ``kv_cache.truncate``, the scheduler's rollback, the paged step's
logits at every chunk position, and the engine with ``spec_k`` stepped in
lockstep with the JAX spec engine (the same plans, tokens and stats) and
against the port's own engine without speculation."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pinned container image: degraded deterministic sweep
    from _hypothesis_fallback import given, settings, strategies as st

from repro.configs import get_config as jax_get_config
from repro.core import quant as jquant
from repro.nn import ModelConfig as JaxModelConfig
from repro.nn import SparsityConfig as JaxSparsityConfig
from repro.nn import build_model
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import kv_cache as jkv
from repro.serving import spec as jspec
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.core.quant import QuantConfig, quantize_model
from repro_torch.nn.common import ModelConfig, SparsityConfig
from repro_torch.nn.model import LM
from repro_torch.serving import kv_cache, spec
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.scheduler import Request, Scheduler

SPEC_K = 4


# ---------------------------------------------------------------------------
# (a) prompt-lookup drafts, equal to the JAX package's
# ---------------------------------------------------------------------------


@settings(max_examples=50, deadline=None)
@given(st.integers(min_value=0, max_value=10_000),
       st.sampled_from(["random", "periodic"]))
def test_propose_drafts_matches_reference(seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "random":
        hist = rng.integers(0, int(rng.integers(1, 6)),
                            int(rng.integers(0, 40))).tolist()
    else:
        motif = rng.integers(0, 50, int(rng.integers(1, 9)))
        hist = np.tile(motif, int(rng.integers(1, 6))).tolist()
        hist = hist[:len(hist) - int(rng.integers(0, len(motif)))]
    k = int(rng.integers(0, 7))
    hi = int(rng.integers(1, 5))
    lo = int(rng.integers(1, hi + 1))
    got = spec.propose_drafts(hist, k, max_ngram=hi, min_ngram=lo)
    assert got == jspec.propose_drafts(hist, k, max_ngram=hi, min_ngram=lo)
    assert got == spec.PromptLookupDrafter(hi, lo)(hist, k)
    assert len(got) <= k


def test_propose_drafts_cases_and_refusal():
    """The JAX package's drafter cases, and its refusal of bad n-grams."""
    assert spec.propose_drafts([1, 2, 3, 1, 2, 3, 1, 2], 3) == [3, 1, 2]
    assert spec.propose_drafts([7, 5, 9, 5, 8, 5], 2, max_ngram=1) == [8, 5]
    assert spec.propose_drafts([1, 2, 9, 3, 9], 2) == [3, 9]
    assert spec.propose_drafts([9, 9, 9, 9], 2) == [9]
    assert spec.propose_drafts([5, 6, 7], 2) == []
    assert spec.propose_drafts([5], 3) == []
    assert spec.propose_drafts([1, 2, 3], 0) == []
    with pytest.raises(ValueError):
        spec.PromptLookupDrafter(max_ngram=1, min_ngram=2)


# ---------------------------------------------------------------------------
# (b) truncate: every PageState field equal to the JAX function's
# ---------------------------------------------------------------------------


def _assert_states_equal(tst, jst):
    for f in ("page_table", "n_pages", "seq_lens", "free_stack",
              "first_page"):
        np.testing.assert_array_equal(getattr(tst, f),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    assert tst.free_count == int(jst.free_count)


def _apply(op, args, tst, jst, ps):
    if op == "alloc":
        return (kv_cache.alloc_pages(tst, *args),
                jkv.alloc_pages(jst, *args))
    if op == "advance":
        return kv_cache.advance(tst, *args), jkv.advance(jst, *args)
    if op == "reclaim":
        return (kv_cache.release_prefix(tst, *args),
                jkv.release_prefix(jst, *args))
    if op == "truncate":
        return (kv_cache.truncate(tst, *args, ps),
                jkv.truncate(jst, *args, ps))
    return kv_cache.free_slot(tst, *args), jkv.free_slot(jst, *args)


# the JAX package's two truncate unit cases, as op sequences:
# (slots, total, max pages, page size, ops)
TRUNCATE_CASES = {
    "releases_tail_pages": (2, 8, 4, 4, [
        ("alloc", (0, 3)), ("advance", (0, 9)), ("truncate", (0, 5)),
        ("truncate", (0, 4))]),
    "respects_reclaimed_prefix": (1, 8, 6, 4, [
        ("alloc", (0, 4)), ("advance", (0, 14)), ("reclaim", (0, 2)),
        ("truncate", (0, 5))]),
}


@pytest.mark.parametrize("case", list(TRUNCATE_CASES))
def test_truncate_cases_match_reference(case):
    slots, total, maxp, ps, ops = TRUNCATE_CASES[case]
    tst = kv_cache.init_page_state(slots, total, maxp)
    jst = jkv.init_page_state(slots, total, maxp)
    for op, args in ops:
        tst, jst = _apply(op, args, tst, jst, ps)
        _assert_states_equal(tst, jst)
    if case == "releases_tail_pages":
        assert tst.free_count == total and (tst.page_table == -1).all()
    else:
        assert (int(tst.seq_lens[0]), int(tst.first_page[0]),
                int(tst.n_pages[0]), tst.free_count) == (9, 2, 1, 7)


@settings(max_examples=30, deadline=None)
@given(st.integers(min_value=0, max_value=500))
def test_truncate_page_accounting_matches_reference(seed):
    """Random alloc / advance / reclaim / truncate / free streams on the
    port's and the JAX package's allocator: every field equal after every
    op, and the pool whole at the end."""
    rng = np.random.default_rng(seed)
    slots, total, ps, maxp = 3, 10, 4, 5
    tst = kv_cache.init_page_state(slots, total, maxp)
    jst = jkv.init_page_state(slots, total, maxp)
    for _ in range(40):
        slot = int(rng.integers(slots))
        first, n_pages = int(tst.first_page[slot]), int(tst.n_pages[slot])
        seq = int(tst.seq_lens[slot])
        op = ["alloc", "advance", "reclaim", "truncate",
              "free"][int(rng.integers(5))]
        if op == "alloc":
            n = int(rng.integers(0, min(maxp - first - n_pages,
                                        tst.free_count) + 1))
        elif op == "advance":
            n = int(rng.integers(0, (first + n_pages) * ps - seq + 1))
        elif op == "reclaim":   # only pages wholly below the write head
            n = int(rng.integers(0, max(0, min(seq // ps - first,
                                               n_pages)) + 1))
        elif op == "truncate":  # never into reclaimed positions
            n = int(rng.integers(0, seq - first * ps + 1))
        args = (slot,) if op == "free" else (slot, n)
        tst, jst = _apply(op, args, tst, jst, ps)
        _assert_states_equal(tst, jst)
    for slot in range(slots):
        tst, jst = _apply("free", (slot,), tst, jst, ps)
    _assert_states_equal(tst, jst)
    assert tst.free_count == total
    assert set(tst.free_stack.tolist()) == set(range(total))


# ---------------------------------------------------------------------------
# (c) the scheduler's rollback: no page leaked or freed twice
# ---------------------------------------------------------------------------


@st.composite
def scheduler_cases(draw):
    slots = draw(st.integers(min_value=1, max_value=3))
    total_pages = draw(st.integers(min_value=2, max_value=10))
    page_size = draw(st.sampled_from([2, 4]))
    max_pages = draw(st.integers(min_value=2, max_value=6))
    budget = draw(st.integers(min_value=1, max_value=12))
    chunk = draw(st.sampled_from([2, 4, 8]))
    n_reqs = draw(st.integers(min_value=1, max_value=6))
    seed = draw(st.integers(min_value=0, max_value=100))
    return slots, total_pages, page_size, max_pages, budget, chunk, \
        n_reqs, seed


@settings(max_examples=20, deadline=None)
@given(scheduler_cases())
def test_scheduler_spec_rollback_no_leaks(case):
    """The JAX package's speculative property test on the port's
    scheduler: random drafts, a random accepted prefix per decode slot
    (``note_verified``: advance, truncate, then window reclamation), and
    ``check_invariants`` after every plan and every rollback."""
    slots, total_pages, page_size, max_pages, budget, chunk, n_reqs, seed \
        = case
    rng = np.random.default_rng(seed)
    window = int(rng.integers(1, 2 * page_size + 1)) if seed % 2 else None
    spec_k = int(rng.integers(1, 5))

    def random_drafter(tokens, k):
        return [int(t) for t in rng.integers(0, 99, k)]

    cap = min(max_pages, total_pages) * page_size
    sched = Scheduler(slots=slots, total_pages=total_pages,
                      page_size=page_size, max_pages_per_seq=max_pages,
                      token_budget=budget, prefill_chunk=chunk,
                      window=window, spec_k=spec_k, drafter=random_drafter)
    for i in range(n_reqs):
        plen = int(rng.integers(1, max(2, cap - 1)))
        gen = int(rng.integers(1, max(2, cap - plen)))
        sched.add(Request(req_id=i, prompt=rng.integers(0, 99, plen),
                          max_new_tokens=gen))
    for _ in range(500):
        if not sched.has_work():
            break
        plan = sched.schedule()
        sched.check_invariants()
        assert set(plan.drafts) <= set(plan.decode_slots)
        assert all(len(d) <= spec_k for d in plan.drafts.values())
        assert plan.n_tokens <= budget
        for slot, _, toks in plan.prefills:
            seq = sched.active[slot]
            sched.advance_prefill(slot, len(toks))
            if not seq.prefilling and len(seq.tokens) == seq.n_prefilled:
                sched.append_token(slot, int(rng.integers(0, 99)))
        for slot in plan.decode_slots:
            drafts = plan.drafts.get(slot, [])
            m = int(rng.integers(0, len(drafts) + 1))
            sched.note_verified(slot, n_written=1 + len(drafts),
                                n_accepted=1 + m)
            sched.check_invariants()
            for _ in range(1 + m):
                sched.append_token(slot, int(rng.integers(0, 99)))
        for slot in range(slots):
            seq = sched.active[slot]
            if seq is not None and seq.done:
                sched.finish(slot)
        sched.check_invariants()
        if plan.n_tokens == 0 and not plan.admitted:
            break
    sched.check_invariants()
    if not any(s is not None for s in sched.active) and not sched.waiting:
        assert sched.state.free_count == total_pages


# ---------------------------------------------------------------------------
# (d) paged_step(all_logits=True) against the JAX one
# ---------------------------------------------------------------------------

TOL = 1e-5  # of max |JAX logit|, f32


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _gemma_pair(n_layers=None, seed=0):
    jcfg = jax_get_config("gemma3_4b", smoke=True)
    tcfg = get_config("gemma3_4b", smoke=True)
    if n_layers is not None:
        jcfg, tcfg = jcfg.with_(n_layers=n_layers), \
            tcfg.with_(n_layers=n_layers)
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.key(seed))

    def port_model():
        m = LM(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
        m.load_state_dict(from_jax_params(_np_tree(params), m), strict=False)
        return m
    return jcfg, jmodel, params, port_model


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_step_all_logits_matches_reference(quant):
    """A prefill chunk, then one verify chunk of 1 + k positions whose rows
    have ``n_new`` 0, 1 and 1 + k: the logits at every valid position equal
    the JAX ``paged_step(all_logits=True)``'s, f32 and int8 (weights and
    KV pages)."""
    jcfg, jmodel, params, port_model = _gemma_pair(n_layers=2)
    tmodel = port_model()
    if quant:
        params, _ = jquant.quantize_tree(params, jmodel.spec())
        quantize_model(tmodel)
    rng = np.random.default_rng(7)
    b, page, total, per_seq, c = 3, 4, 15, 5, 1 + SPEC_K
    st_ = jkv.init_page_state(b, total, per_seq)
    for i in range(b):
        st_ = jkv.alloc_pages(st_, i, per_seq)
    table = np.array(st_.page_table)
    jcache = jmodel.stack.init_paged_cache(b, total, page, jnp.float32,
                                           quant_kv=quant)
    tcache = tmodel.init_paged_cache(total, page, torch.float32,
                                     quant_kv=quant)
    jstep = jax.jit(functools.partial(jmodel.paged_step, backend="xla"),
                    static_argnames=("all_logits",))

    def step(tokens, pos, n_new, all_logits):
        nonlocal jcache
        jl, jcache = jstep(
            params, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(n_new),
            jcache, jnp.asarray(table), jnp.arange(b, dtype=jnp.int32),
            all_logits=all_logits)
        tl = tmodel.paged_step(torch.from_numpy(tokens), torch.from_numpy(pos),
                               torch.from_numpy(n_new), tcache,
                               torch.from_numpy(table), all_logits=all_logits)
        return tl.numpy(), np.asarray(jl)

    prompt = rng.integers(0, jcfg.vocab_size, (b, 8)).astype(np.int32)
    lens = np.asarray([8, 6, 7], np.int32)
    tl, jl = step(prompt, np.zeros(b, np.int32), lens, False)
    assert tl.shape == jl.shape == (b, 1, jcfg.vocab_size)
    n_new = np.asarray([0, 1, c], np.int32)
    chunk = rng.integers(0, jcfg.vocab_size, (b, c)).astype(np.int32)
    tl, jl = step(chunk, lens, n_new, True)
    assert tl.shape == jl.shape == (b, c, jcfg.vocab_size)
    for r in range(b):
        valid = slice(0, int(n_new[r]))
        err = np.abs(tl[r, valid] - jl[r, valid]).max(initial=0.0)
        assert err <= TOL * np.abs(jl[:, :1]).max(), (r, err)
    # the last valid position's logits are what all_logits=False returns
    assert np.isfinite(tl).all()
    # a plain decode step after the verify chunk, from the rows' new ends
    tok = tl[np.arange(b), np.maximum(n_new - 1, 0)].argmax(-1)
    tl2, jl2 = step(tok.astype(np.int32)[:, None], lens + n_new,
                    np.ones(b, np.int32), False)
    np.testing.assert_allclose(tl2, jl2, atol=TOL * np.abs(jl2).max(),
                               rtol=0)


# ---------------------------------------------------------------------------
# (e) the engine with spec_k, in lockstep with the JAX spec engine
# ---------------------------------------------------------------------------


def _tiny_pair(sparse=False, seed=0, **kw):
    """The JAX package's ``tests/test_serving.py::_tiny_cfg`` model and the
    port's with its weights."""
    sp = dict(enabled=sparse, rho_ffn=(0.5, 1.0), block_in=16, block_out=16)
    base = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab_size=256, loss_chunk=16, dtype="float32", remat=False,
                **kw)
    jmodel = build_model(JaxModelConfig(sparsity=JaxSparsityConfig(**sp),
                                        attn_chunk=16, **base))
    params = jmodel.init(jax.random.key(seed))
    cfg = ModelConfig(sparsity=SparsityConfig(**sp), **base)

    def port_model():
        m = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        m.load_state_dict(from_jax_params(_np_tree(params), m), strict=False)
        return m
    return jmodel.cfg, jmodel, params, port_model


def _periodic_prompt(rng, vocab, period, reps):
    motif = rng.integers(0, vocab, period).astype(np.int32)
    return np.tile(motif, reps)


def _case(name):
    """(models, prompts, new tokens, engine knobs, quant) of the JAX
    package's spec tests (``tests/test_serving.py``), with their seeds and
    prompts, and an int8 case on the gemma3 smoke config."""
    if name in ("dense", "sparse"):
        models = _tiny_pair(sparse=name == "sparse")
        rng = np.random.default_rng(21)
        prompts = [_periodic_prompt(rng, 256, 5, 3),
                   rng.integers(0, 256, 9).astype(np.int32)]
        return models, prompts, 16, dict(
            max_slots=2, page_size=4, total_pages=24, max_pages_per_seq=10,
            token_budget=24, prefill_chunk=8), None
    if name == "window":
        models = _tiny_pair(layer_pattern=("local",), attn_window=6)
        rng = np.random.default_rng(22)
        prompts = [_periodic_prompt(rng, 256, 4, 3),
                   rng.integers(0, 256, 5).astype(np.int32)]
        return models, prompts, 24, dict(
            max_slots=2, page_size=4, total_pages=16, max_pages_per_seq=16,
            token_budget=16, prefill_chunk=8), None
    if name == "preempt":
        models = _tiny_pair()
        rng = np.random.default_rng(23)
        prompts = [_periodic_prompt(rng, 256, 4, 2 + i % 2)
                   for i in range(4)]
        return models, prompts, 8, dict(
            max_slots=4, page_size=4, total_pages=7, max_pages_per_seq=6,
            token_budget=12, prefill_chunk=8), None
    models = _gemma_pair(n_layers=2 if name == "gemma3_int8" else None)
    rng = np.random.default_rng(24)
    vocab = models[0].vocab_size
    prompts = [_periodic_prompt(rng, vocab, 4, 2),
               rng.integers(0, vocab, 6).astype(np.int32)]
    knobs = dict(max_slots=2, page_size=4, total_pages=12,
                 max_pages_per_seq=6, token_budget=16, prefill_chunk=8)
    if name == "gemma3":
        return models, prompts, 6, knobs, None
    return models, prompts, 12, knobs, (True, True)


def _plan_key(plan):
    return (plan.decode_slots, plan.drafts,
            [(s, p, t.tolist()) for s, p, t in plan.prefills],
            plan.admitted, plan.preempted)


ENGINE_CASES = ["dense", "sparse", "window", "preempt", "gemma3",
                "gemma3_int8"]


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_spec_engine_matches_reference_engine(case):
    (_, jmodel, params, port_model), prompts, n_new, knobs, quant = \
        _case(case)
    jq = tq = None
    if quant is not None:
        jq, tq = jquant.QuantConfig(*quant), QuantConfig(*quant)
    ref = JaxServingEngine(jmodel, params, JaxEngineConfig(
        backend="xla", metrics=False, spec_k=SPEC_K, quant=jq, **knobs))
    eng = ServingEngine(port_model(), EngineConfig(
        spec_k=SPEC_K, quant=tq, **knobs), device="cpu")
    for e in (ref, eng):
        for i, p in enumerate(prompts):
            e.add_request(p, n_new, req_id=i)
    while ref.sched.has_work():
        jplan, _ = ref.step()
        plan, _ = eng.step()
        assert _plan_key(plan) == _plan_key(jplan)
        eng.sched.check_invariants()
    assert not eng.sched.has_work()
    want = [ref.outputs[i].tolist() for i in range(len(prompts))]
    assert [eng.outputs[i].tolist() for i in range(len(prompts))] == want
    for k in ("spec_drafted", "spec_accepted", "steps", "reclaimed_pages",
              "preempted"):
        assert eng.sched.stats[k] == ref.sched.stats[k], k
    assert eng.spec_k == SPEC_K and eng.sched.stats["spec_drafted"] > 0
    # the port without speculation gives the same tokens in more steps
    base = ServingEngine(port_model(), EngineConfig(quant=tq, **knobs),
                         device="cpu")
    assert [o.tolist() for o in base.run(prompts, n_new)] == want
    assert base.sched.stats["spec_drafted"] == 0
    if eng.sched.stats["spec_accepted"]:
        assert eng.sched.stats["steps"] < base.sched.stats["steps"]
    if case == "window":
        assert eng.sched.window == 6 and eng.sched.stats["reclaimed_pages"]
    if case == "preempt":
        assert eng.sched.stats["preempted"] > 0


def test_spec_clamped_unless_greedy():
    """Acceptance compares argmax continuations: a sampling engine runs
    without drafts, as the JAX engine does."""
    model = LM(get_config("gemma3_4b", smoke=True).with_(n_layers=1),
               device="cpu", generator=torch.Generator().manual_seed(0))
    eng = ServingEngine(model, EngineConfig(
        max_slots=2, page_size=4, total_pages=12, max_pages_per_seq=6,
        greedy=False, spec_k=SPEC_K), device="cpu")
    assert eng.spec_k == 0 and eng.sched.drafter is None
    prompt = np.tile(np.arange(4, dtype=np.int32), 3)
    eng.run([prompt], 6)
    assert eng.sched.stats["spec_drafted"] == 0


@pytest.mark.parametrize("kv", [False, True], ids=["f32-pages",
                                                  "int8-pages"])
def test_rollback_then_plain_decode_reads_no_stale_kv(kv):
    """Rolled-back positions keep their stale K/V (and scales) until they
    are overwritten: after a verify step whose drafts are all rejected, the
    next plain decode step (the paged decode path, masked by length) gives
    the logits of an engine that never saw the drafts."""
    model = LM(get_config("gemma3_4b", smoke=True).with_(n_layers=2),
               device="cpu", generator=torch.Generator().manual_seed(3))
    knobs = dict(max_slots=2, page_size=4, total_pages=12,
                 max_pages_per_seq=6, token_budget=16, prefill_chunk=8,
                 quant=QuantConfig(weights=False, kv=kv))
    prompt = np.arange(5, 13, dtype=np.int32)
    ref = ServingEngine(model, EngineConfig(**knobs), device="cpu")
    eng = ServingEngine(model, EngineConfig(spec_k=SPEC_K, **knobs),
                        device="cpu")
    for e in (ref, eng):
        e.add_request(prompt, 8, req_id=0)
        e.step()                                # prefill + first token
    ref.step()                                  # plain decode
    t1 = ref.sched.active[0].tokens[-1]
    drafts = [(t1 + 1 + i) % model.cfg.vocab_size for i in range(SPEC_K)]
    eng.sched.drafter = lambda toks, k: drafts[:k]
    plan, _ = eng.step()                        # verify, all rejected
    assert plan.drafts == {0: drafts}
    assert eng.sched.stats["spec_accepted"] == 0
    assert eng.sched.active[0].tokens == ref.sched.active[0].tokens
    st_e, st_r = eng.sched.state, ref.sched.state
    np.testing.assert_array_equal(st_e.page_table, st_r.page_table)
    np.testing.assert_array_equal(st_e.seq_lens, st_r.seq_lens)
    # the rejected drafts' K/V is still in the slot's last page
    n = int(st_e.seq_lens[0])
    page = int(st_e.page_table[0, n // 4])
    for c_e, c_r in zip(eng.cache, ref.cache):
        for k in c_e:
            assert c_e[k][page, n % 4:].abs().amax() > 0, k
            assert c_r[k][page, n % 4:].abs().amax() == 0, k
    tokens = np.zeros((2, 1), np.int32)
    tokens[0, 0] = eng.sched.active[0].pending_token
    n_new = np.asarray([1, 0], np.int32)
    got = eng._run(tokens, st_e.seq_lens, n_new)[0, 0]
    want = ref._run(tokens, st_r.seq_lens, n_new)[0, 0]
    torch.testing.assert_close(got, want, rtol=0,
                               atol=TOL * float(want.abs().max()))
