"""LoD through paddle_tpu_torch's executor, on the CPU (fluid/executor.py):

- the interpreter hands ``needs_lod`` ops their inputs' LoD and writes
  each output's (declared, or the ShareLoD rule by leading length); the
  fetched LoDs of a forward, a pooled and a grad var equal the TPU
  package's;
- the compiled plan keys by its feeds' LoDs and binds them at its first
  run: bitwise the interpreter's, one plan a LoD, a fixed-LoD batch reused;
- a segmented block (an ``auc`` island) fed LoD: its segments key by
  their inputs' LoD, the island takes LoDTensors and what it writes keeps
  its LoD; an island that writes a LoD from values (``sequence_erase``)
  gives the next segment a new plan;
- the GPU's schedule rehearsed with fake CUDA graphs: eager, capture,
  replays, bitwise the interpreter's, and no LoD constant made from the
  host during a capture; a segment whose LoD no graph was captured for
  runs the step's rest eagerly and the graphs are captured anew;
- a window refuses a LoD fetch, with the TPU package's message;
- the eviction of plans that never captured.
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import core
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.ops import sequence_ops

_FLAGS = ("FLAGS_executor_mode", "FLAGS_executor_seg_min_ops")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these small kernels gain nothing from more,
    several test processes share the host's cores, and the CPU's BLAS
    may split a product differently from call to call when its threads
    are contended, which the bitwise checks here would see."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = {k: core.globals_[k] for k in _FLAGS}
    yield
    for k, v in saved.items():
        core.set_flag(k, v)


def _program(fl, island=False, erase=False):
    """ids (LoD) → [sequence_erase →] embedding → sequence_conv (tanh) →
    sequence_pool(max) ‖ dense → fc softmax → cross_entropy, SGD; with
    ``island`` an auc of the prediction. → (main, startup, fetches)."""
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 5
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        ids = fl.data("ids", shape=[1], dtype="int64", lod_level=1)
        dense = fl.data("dense", shape=[4], dtype="float32")
        label = fl.data("label", shape=[1], dtype="int64")
        src = _erase(fl, ids, [3]) if erase else ids
        emb = fl.layers.embedding(src, size=[20, 6])
        conv = fl.layers.sequence_conv(emb, num_filters=5, filter_size=3,
                                       act="tanh")
        pooled = fl.layers.sequence_pool(conv, "max")
        feat = fl.layers.concat([pooled, dense], axis=1)
        pred = fl.layers.fc(feat, 2, act="softmax")
        loss = fl.layers.mean(fl.layers.cross_entropy(pred, label))
        fetch = [loss, emb, conv, pooled]
        if island:
            auc, _ = fl.layers.auc(pred, label)
            fetch.append(auc)
        fl.optimizer.SGD(0.1).minimize(loss)
    return main, startup, fetch


def _erase(fl, ids, tokens):
    """A sequence_erase op (no layer wraps it in either package)."""
    block = fl.default_main_program().global_block()
    out = block.create_var(name="ids_erased", dtype=ids.dtype,
                           shape=(-1, 1))
    block.append_op(type="sequence_erase", inputs={"X": [ids]},
                    outputs={"Out": [out]}, attrs={"tokens": list(tokens)})
    return out


def _batch(rng, lens):
    offs = [0] + np.cumsum(lens).tolist()
    ids = rng.randint(0, 20, (offs[-1], 1)).astype(np.int64)
    return ids, [int(o) for o in offs], {
        "dense": rng.rand(len(lens), 4).astype(np.float32),
        "label": rng.randint(0, 2, (len(lens), 1)).astype(np.int64)}


def _tfeed(ids, offs, rest):
    return dict(rest, ids=fluid.LoDTensor(torch.from_numpy(ids), [offs]))


def _runs(feeds, mode, program_kw=(), fake=False):
    """The port's runs of ``_program`` over ``feeds`` in ``mode`` from one
    start. → (fetches as LoDTensors, executor, state)."""
    core.set_flag("FLAGS_executor_mode", mode)
    core.set_flag("FLAGS_executor_seg_min_ops", 2)
    main, startup, fetch = _program(fluid, **dict(program_kw))
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    if fake:
        exe._stream = "fake"
    out, execs = [], []
    for f in feeds:
        out.append(exe.run(main, feed=f, fetch_list=fetch, scope=scope,
                           return_numpy=False))
        execs.append(getattr(exe._last_block, "last_exec", None)
                     if mode == "compiled" else "interpreted")
    state = {v.name: scope.find_var(v.name).value().array.clone()
             for v in main.global_block().vars.values() if v.persistable}
    return out, execs, exe, state


def _same(a, b):
    for sa, sb in zip(a, b):
        for x, y in zip(sa, sb):
            assert torch.equal(x.array, y.array)
            assert x.lod() == y.lod()


def _same_state(a, b):
    assert sorted(a) == sorted(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


def test_fetched_lods_match_the_tpu_package():
    rng = np.random.RandomState(0)
    ids, offs, rest = _batch(rng, [3, 0, 5, 2])
    t_out, _, _, _ = _runs([_tfeed(ids, offs, rest)], "interpreted")
    c_out, _, exe, _ = _runs([_tfeed(ids, offs, rest)], "compiled")
    assert exe._last_run_mode == "compiled"
    main, startup, fetch = _program(jfluid)
    jexe, jscope = jfluid.Executor(), jcore.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(startup)
        j_out = jexe.run(main, feed=dict(rest, ids=jcore.LoDTensor(
            ids, lod=[offs])), fetch_list=fetch, return_numpy=False)
    want = [t.lod() for t in j_out]
    assert want[1] == [offs] and want[2] == [offs] and want[3] == []
    assert [t.lod() for t in t_out[0]] == want
    assert [t.lod() for t in c_out[0]] == want
    _same(c_out, t_out)


def test_grad_ops_get_their_forward_ops_lod():
    """A grad op of a needs_lod op reads the LoD of its forward inputs, and
    X@GRAD takes X's LoD by its leading length."""
    main, startup, fetch = _program(fluid)
    grads = [op for op in main.global_block().ops
             if op.type == "sequence_conv_grad"]
    assert grads and texecutor._op_needs_lod(grads[0])
    core.set_flag("FLAGS_executor_mode", "interpreted")
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    ids, offs, rest = _batch(np.random.RandomState(1), [2, 4])
    exe.run(main, feed=_tfeed(ids, offs, rest), fetch_list=fetch,
            scope=scope)
    xg = grads[0].output("X@GRAD")[0]
    assert scope.find_var(xg).value().lod() == [offs]


def test_compiled_plans_key_by_lod_and_match_the_interpreter():
    rng = np.random.RandomState(2)
    a = _batch(rng, [3, 1, 4])
    b = _batch(rng, [2, 2, 2])
    feeds = [_tfeed(*a), _tfeed(*a), _tfeed(*b), _tfeed(*a)]
    c_out, _, exe, c_state = _runs(feeds, "compiled")
    i_out, _, _, i_state = _runs(feeds, "interpreted")
    _same(c_out, i_out)
    _same_state(c_state, i_state)
    plans = {k: cb for k, cb in exe._compiled_cache.items() if k[-1]}
    assert len(plans) == 2  # one a LoD: the fixed LoD's plan reused
    assert sorted(cb.stats["eager"] for cb in plans.values()) == [1, 3]
    cb = exe._last_block
    assert cb.fetch_lods[1] == (tuple(a[1]),) and cb.fetch_lods[3] is None
    # every LoD-reading op bound its LoD and a cache of its constants
    bound = [st for st in cb._units if "_lod" in st.attrs]
    assert bound and all(st.attrs["_lodc"] for st in bound
                         if st.op.type.startswith("sequence"))


def test_segmented_block_with_lod_feeds_matches_the_interpreter():
    rng = np.random.RandomState(3)
    a = _batch(rng, [3, 0, 4, 1])
    feeds = [_tfeed(*a), _tfeed(*_batch(rng, [2, 5])), _tfeed(*a)]
    s_out, _, exe, s_state = _runs(feeds, "compiled", {"island": True})
    i_out, _, _, i_state = _runs(feeds, "interpreted", {"island": True})
    assert exe._last_run_mode == "segmented"
    _same(s_out, i_out)
    _same_state(s_state, i_state)
    seg = next(s for s in exe._last_block.segments if s.kind == "compiled")
    assert list(seg.plans) and all(k for k in seg.plans)


def test_island_written_lod_gives_the_next_segment_a_plan():
    """sequence_erase (stateful: its output's size is the data's) writes
    a LoD from values; the segment after it keys its plans by that LoD."""
    rng = np.random.RandomState(4)
    ids, offs, rest = _batch(rng, [4, 3, 5])
    ids2 = ids.copy()
    ids2[ids2 == 3] = 9
    ids[:3] = 3  # erased: another LoD downstream
    feeds = [_tfeed(ids, offs, rest), _tfeed(ids2, offs, rest)] * 2
    s_out, _, exe, s_state = _runs(feeds, "compiled", {"erase": True})
    i_out, _, _, i_state = _runs(feeds, "interpreted", {"erase": True})
    assert exe._last_run_mode == "segmented"
    _same(s_out, i_out)
    _same_state(s_state, i_state)
    seg = [s for s in exe._last_block.segments if s.kind == "compiled"][0]
    assert len(seg.plans) == 2


def test_window_refuses_a_lod_fetch():
    main, startup, fetch = _program(fluid)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    ids, offs, rest = _batch(np.random.RandomState(5), [2, 3])
    feed = _tfeed(ids, offs, rest)
    (loss,) = exe.run(main, feed=feed, fetch_list=fetch[:1], scope=scope,
                      n_steps=2)
    assert loss.shape == (2, 1)
    with pytest.raises(NotImplementedError,
                       match="cannot stack LoD-carrying fetches"):
        exe.run(main, feed=feed, fetch_list=fetch[:2], scope=scope,
                n_steps=2)


def test_plans_that_never_captured_are_evicted():
    main, startup, fetch = _program(fluid)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(6)
    for n in range(3, 12):
        exe.run(main, feed=_tfeed(*_batch(rng, [n, 2])), fetch_list=fetch,
                scope=scope)
    lod_keys = [k for k in exe._compiled_cache if k[-1]]
    assert len(lod_keys) == fluid.Executor._LOD_PLANS_KEPT
    assert list(exe._lod_plan_keys) == lod_keys


# ------------------------------------------ the GPU's schedule, rehearsed
class _FakeGraph:
    """A CUDA graph stand-in. The fake capture context records nothing, so
    a capture runs the work eagerly: the replay right after it does
    nothing, every later one re-runs ``fn``."""

    def __init__(self):
        self.fn = None
        self.skip = True

    def replay(self):
        if self.skip:
            self.skip = False
        elif self.fn is not None:
            self.fn()


@pytest.fixture
def fake_graphs(monkeypatch):
    """The compiled and segmented blocks' GPU paths on the CPU: fake
    graphs whose replay re-runs the captured plan on the captured tensors,
    and a capture during which making a LoD constant from the host
    raises."""
    capturing = []
    real_from_numpy = torch.from_numpy

    def from_numpy(a):
        assert not capturing, "a LoD constant made during a capture"
        return real_from_numpy(a)

    @contextlib.contextmanager
    def graph(*a, **k):
        capturing.append(1)
        try:
            yield
        finally:
            capturing.pop()

    monkeypatch.setattr(sequence_ops.torch, "from_numpy", from_numpy)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    real_capture = texecutor._CompiledBlock._capture

    def capture(self, scope, feeds):
        real_capture(self, scope, feeds)
        state = {n: self._captured[n] for n in self.mut_state + self.ro_state}
        counter = self._captured["@RNG_COUNTER@"]
        targets = dict(state, **self._extra_targets)

        def replay():
            fetches, new, _ = self._step(self._static_feeds, state, counter)
            for t, v in zip(self._static_fetch, fetches):
                t.copy_(v)
            for n, v in new.items():
                if n in targets and v is not targets[n]:
                    targets[n].copy_(v)
        self._graph.fn = replay

    real_seg_capture = texecutor._SegmentedBlock._capture_segment

    def seg_capture(self, seg, plan, env, stable, rt):
        seen = {n: env[n] for n in seg.in_names if n in env}
        outs, flag = real_seg_capture(self, seg, plan, env, stable, rt)
        graph, static_in, captured, _ = rt[plan.key]
        inputs = dict(seen, **static_in)

        def replay():
            o, _ = self._seg_compute(seg, plan, inputs)
            for n, t in captured.items():
                if o[n] is not t:
                    t.copy_(o[n])
        graph.fn = replay
        graph.skip = False  # its capture replayed already
        return outs, flag

    def run(self, scope, feeds, return_numpy=True):
        fetched, self.last_health = self._run_on_stream(scope, feeds)
        return self._fetched([t.clone() for t in fetched], return_numpy)

    monkeypatch.setattr(texecutor._CompiledBlock, "_capture", capture)
    monkeypatch.setattr(texecutor._SegmentedBlock, "_capture_segment",
                        seg_capture)
    monkeypatch.setattr(texecutor._CompiledBlock, "run", run)
    monkeypatch.setattr(texecutor._SegmentedBlock, "run", run)


@pytest.mark.parametrize("island", [False, True],
                         ids=["compiled", "segmented"])
def test_fixed_lod_captures_and_replays(fake_graphs, island):
    rng = np.random.RandomState(7)
    a = _batch(rng, [3, 0, 4, 1])
    feeds = [_tfeed(*a)] * 5
    g_out, execs, exe, g_state = _runs(feeds, "compiled",
                                       {"island": island}, fake=True)
    i_out, _, _, i_state = _runs(feeds, "interpreted", {"island": island})
    assert exe._last_run_mode == ("segmented" if island else "compiled")
    assert execs == ["eager", "capture", "replay", "replay", "replay"]
    _same(g_out, i_out)
    _same_state(g_state, i_state)


def test_new_segment_lod_falls_back_and_recaptures(fake_graphs):
    rng = np.random.RandomState(8)
    ids, offs, rest = _batch(rng, [4, 3, 5])
    ids2 = ids.copy()
    ids2[ids2 == 3] = 9
    ids[:3] = 3
    a, b = _tfeed(ids, offs, rest), _tfeed(ids2, offs, rest)
    feeds = [a, b, a, a, b, b, b]
    g_out, execs, exe, g_state = _runs(feeds, "compiled", {"erase": True},
                                       fake=True)
    i_out, _, _, i_state = _runs(feeds, "interpreted", {"erase": True})
    assert execs == ["eager", "eager", "capture", "replay", "eager",
                     "capture", "replay"]
    _same(g_out, i_out)
    _same_state(g_state, i_state)
