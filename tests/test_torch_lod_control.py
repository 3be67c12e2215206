"""StaticRNN, DynamicRNN, IfElse, the LoD rank-table ops, the recurrent op,
the RNN cells, the decode helpers and the contrib decoders of
paddle_tpu_torch against the TPU package, on the CPU (the cases of
tests/test_dynamic_rnn.py, test_static_rnn.py, test_contrib_decoder.py and
test_rnn_ops.py's decode, each program built by both packages from one
function of the ``fluid`` module):

- the fetches at rtol 1e-5, atol 1e-6 and their LoDs bitwise, the port's
  compiled run (interpreted or segmented around the islands) bitwise its
  interpreter's;
- the rank table's order (stable, longest first), lod_tensor_to_array's
  refusal of a non-innermost level, array_to_lod_tensor with a RankTable,
  shrink_rnn_memory's and reorder_lod_tensor_by_rank's grads (row
  gathers summed back in a fixed order);
- the op lists of every program alike.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy
from paddle_tpu_torch.ops.registry import OPS as TOPS
from paddle_tpu_torch.ops.registry import run_generic_grad as t_generic_grad

RTOL, ATOL = 1e-5, 1e-6


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
def _pin_seed():
    old = jcore.globals_["FLAGS_seed"]
    jcore.globals_["FLAGS_seed"] = 0
    yield
    jcore.globals_["FLAGS_seed"] = old


def _types(prog):
    return [[op.type for op in b.ops if op.type not in ("feed", "fetch")]
            for b in prog.blocks]


def _lod(v):
    return [list(map(int, lv)) for lv in v.lod()]


def _run_both(build, feed, steps=1, rtol=RTOL, atol=ATOL, exact=(),
              own_lod=()):
    """``build(fluid)`` → (main, startup, fetch vars) in both packages; the
    port's parameters set to the TPU package's startup values; ``steps``
    runs of ``feed`` ({name: array or (array, offsets)}) by the TPU
    package, the port compiled and the port interpreted. Every fetch
    compared (those at ``exact`` bitwise) with its LoD (but those at
    ``own_lod``). → (the port's fetches of the last step, the TPU
    package's)."""
    with jfluid.unique_name.guard():
        jm, js, jf = build(jfluid)
    with tfluid.unique_name.guard():
        tm, ts, tf = build(tfluid)
    assert _types(tm) == _types(jm)
    jexe, jscope = jfluid.Executor(), jcore.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope, iscope = tfluid.Scope(), tfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
    names = [v.name for v in js.global_block().vars.values()
             if v.persistable]
    for sc in (tscope, iscope):
        texe.run(ts, scope=sc)
        set_params_from_numpy(sc, {n: np.asarray(
            jscope.find_var(n).get_tensor().array) for n in names})
    jfeed, tfeed = {}, {}
    for k, v in feed.items():
        if isinstance(v, tuple):
            jfeed[k] = jcore.LoDTensor(v[0], lod=[list(o) for o in v[1]])
            tfeed[k] = tfluid.LoDTensor(torch.from_numpy(v[0]),
                                        [list(o) for o in v[1]])
        else:
            jfeed[k] = tfeed[k] = v
    for _ in range(steps):
        with jfluid.scope_guard(jscope):
            jo = jexe.run(jm, feed=jfeed, fetch_list=jf, return_numpy=False)
        to = texe.run(tm, feed=tfeed, fetch_list=tf, scope=tscope,
                      return_numpy=False)
        tcore.set_flag("FLAGS_executor_mode", "interpreted")
        try:
            io = texe.run(tm, feed=tfeed, fetch_list=tf, scope=iscope,
                          return_numpy=False)
        finally:
            tcore.set_flag("FLAGS_executor_mode", "compiled")
        for k, (t, j, i) in enumerate(zip(to, jo, io)):
            jv = np.asarray(j.array if hasattr(j, "array") else j)
            if k in exact:
                np.testing.assert_array_equal(t.numpy(), jv)
            else:
                np.testing.assert_allclose(t.numpy(), jv, rtol=rtol,
                                           atol=atol)
            assert np.array_equal(t.numpy(), i.numpy()), k
            if hasattr(j, "lod") and k not in own_lod:
                assert _lod(t) == _lod(j), k
    return [t.numpy() for t in to], jo


# ------------------------------------------------------ rank-table ops
def test_lod_rank_table_and_friends():
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[2], dtype="float32",
                                  lod_level=1)
            table = fluid.layers.lod_rank_table(x)
            mlen = fluid.layers.max_sequence_len(table)
            arr = fluid.layers.lod_tensor_to_array(x, table)
            back = fluid.layers.array_to_lod_tensor(arr, table)
            reord = fluid.layers.reorder_lod_tensor_by_rank(x, table)
        return main, startup, [mlen, back, reord]
    X = np.arange(16, dtype=np.float32).reshape(8, 2)
    # the TPU package's executor shares X's LoD with the reordered rows
    # (its kernel writes the scope, then the executor's ShareLoD runs);
    # the port's keeps the LoD of the rows it holds (ROADMAP C)
    (ml, bk, ro), _ = _run_both(build, {"x": (X, [[0, 2, 5, 6, 8]])},
                                exact=(0, 1, 2), own_lod=(2,))
    assert ml[0] == 3
    np.testing.assert_array_equal(bk, X)
    # rank order, ties stable: seq1 (3), seq0 (2), seq3 (2), seq2 (1)
    np.testing.assert_array_equal(ro, X[[2, 3, 4, 0, 1, 6, 7, 5]])
    with tfluid.unique_name.guard():
        main, startup, fetch = build(tfluid)
    (out,) = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"x": tfluid.LoDTensor(torch.from_numpy(X),
                                          [[0, 2, 5, 6, 8]])},
        fetch_list=fetch[2:], scope=tfluid.Scope(), return_numpy=False)
    assert _lod(out) == [[0, 3, 5, 7, 8]]


def test_rank_table_without_lod():
    """Rows without LoD are sequences of length 1: the rank table keeps
    their order."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[2], dtype="float32")
            table = fluid.layers.lod_rank_table(x)
            reord = fluid.layers.reorder_lod_tensor_by_rank(x, table)
            mlen = fluid.layers.max_sequence_len(table)
        return main, startup, [reord, mlen]
    X = np.arange(12, dtype=np.float32).reshape(6, 2)
    (ro, ml), _ = _run_both(build, {"x": X}, exact=(0, 1))
    np.testing.assert_array_equal(ro, X)
    assert ml[0] == 1


def test_lod_tensor_to_array_refuses_an_outer_level():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[2], dtype="float32", lod_level=2)
        table = tfluid.layers.lod_rank_table(x, level=0)
        arr = tfluid.layers.lod_tensor_to_array(x, table)
        out = tfluid.layers.array_to_lod_tensor(arr, table)
    X = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    with pytest.raises(NotImplementedError, match="non-innermost"):
        tfluid.Executor(tfluid.CPUPlace()).run(
            main, feed={"x": tfluid.LoDTensor(X, [[0, 1, 3], [0, 2, 3, 6]])},
            fetch_list=[out], scope=tfluid.Scope())


class _Op:
    def __init__(self, inputs):
        self.inputs = inputs

    def input(self, slot):
        return self.inputs.get(slot, [])


def _table_scope(items, x=None, lod=None):
    scope = tcore.Scope()
    scope.var("table").set_value(tcore.LoDRankTable(items))
    if x is not None:
        scope.var("x").set_value(tcore.LoDTensor(x, lod))
    return scope


def test_shrink_rnn_memory_and_its_grad():
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    scope = _table_scope([(2, 3), (0, 2), (1, 2), (3, 1)])
    attrs = {"_op": _Op({"X": ["x"], "I": ["i"], "RankTable": ["table"]}),
             "_scope": scope}
    ins = {"X": [x], "I": [torch.tensor([1])]}
    o = TOPS.get("shrink_rnn_memory").kernel(ins, attrs)["Out"][0]
    assert torch.equal(o, x[:3])
    g = torch.ones(3, 2)
    grads = t_generic_grad("shrink_rnn_memory", dict(ins, **{
        "Out": [o], "Out@GRAD": [g]}), attrs, ["X@GRAD"], ["X", "I"])
    assert torch.equal(grads["X@GRAD"][0],
                       torch.tensor([[1., 1], [1, 1], [1, 1], [0, 0]]))


def test_reorder_lod_tensor_by_rank_grad_sums_back():
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    lod = [[0, 2, 5, 6]]
    scope = _table_scope([(1, 3), (0, 2), (2, 1)], x, lod)
    attrs = {"_op": _Op({"X": ["x"], "RankTable": ["table"]}),
             "_scope": scope}
    out = TOPS.get("reorder_lod_tensor_by_rank").kernel({"X": [x]}, attrs)
    assert out["_lod"] == {"Out": [((0, 3, 5, 6),)]}
    perm = [2, 3, 4, 0, 1, 5]
    assert torch.equal(out["Out"][0], x[perm])
    g = torch.randn(6, 2, generator=torch.Generator().manual_seed(0))
    grads = t_generic_grad("reorder_lod_tensor_by_rank", {
        "X": [x], "Out": out["Out"], "Out@GRAD": [g]}, attrs, ["X@GRAD"],
        ["X"])
    want = torch.zeros_like(g)
    want[perm] = g
    assert torch.equal(grads["X@GRAD"][0], want)


# ------------------------------------------------------ IfElse
def test_if_else_splits_and_merges_rows():
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[2], dtype="float32")
            mask = fluid.layers.data("m", shape=[1], dtype="bool")
            ie = fluid.layers.IfElse(mask)
            with ie.true_block():
                # the split rows carry no static shape: fc reads its
                # input's width from it
                xt = fluid.layers.reshape(ie.input(x), [-1, 2])
                ie.output(fluid.layers.fc(xt, 3, act="tanh"))
            with ie.false_block():
                xf = fluid.layers.reshape(ie.input(x), [-1, 2])
                ie.output(fluid.layers.scale(fluid.layers.fc(xf, 3), -1.0))
            out = ie()[0]
        return main, startup, [out]
    rng = np.random.RandomState(0)
    X = rng.rand(5, 2).astype(np.float32)
    M = np.array([[True], [False], [True], [False], [False]])
    _run_both(build, {"x": X, "m": M})


# ------------------------------------------------------ DynamicRNN
def test_dynamic_rnn_accumulates():
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[2], dtype="float32",
                                  lod_level=1)
            drnn = fluid.layers.DynamicRNN()
            with drnn.block():
                step = drnn.step_input(x)
                mem = drnn.memory(shape=[2], value=0.0)
                acc = fluid.layers.elementwise_add(step, mem)
                drnn.update_memory(mem, acc)
                drnn.output(acc)
            out = drnn()
            last = fluid.layers.sequence_last_step(out)
        return main, startup, [out, last]
    X = np.array([[1, 1], [2, 2], [10, 10], [20, 20], [30, 30]], np.float32)
    (o, lst), _ = _run_both(build, {"x": (X, [[0, 2, 5]])}, exact=(0, 1))
    np.testing.assert_array_equal(o, [[1, 1], [3, 3], [10, 10], [30, 30],
                                      [60, 60]])
    np.testing.assert_array_equal(lst, [[3, 3], [60, 60]])


def test_dynamic_rnn_with_init_memory_and_static_input():
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[2], dtype="float32",
                                  lod_level=1)
            boot = fluid.layers.data("boot", shape=[2], dtype="float32")
            stat = fluid.layers.data("stat", shape=[2], dtype="float32")
            drnn = fluid.layers.DynamicRNN()
            with drnn.block():
                step = drnn.step_input(x)
                sv = drnn.static_input(stat)
                mem = drnn.memory(init=boot, need_reorder=True)
                nxt = fluid.layers.elementwise_add(
                    fluid.layers.elementwise_add(step, mem), sv)
                drnn.update_memory(mem, nxt)
                drnn.output(nxt)
            out = drnn()
        return main, startup, [out]
    X = np.array([[1, 1], [2, 2], [3, 3]], np.float32)
    B = np.array([[100, 100], [200, 200]], np.float32)
    S = np.array([[0.5, 0.5], [0.25, 0.25]], np.float32)
    (o,), _ = _run_both(build, {"x": (X, [[0, 1, 3]]), "boot": B,
                                "stat": (S, [[0, 1, 2]])}, exact=(0,))
    np.testing.assert_array_equal(o, [[101.5, 101.5], [202.25, 202.25],
                                      [205.5, 205.5]])


def test_dynamic_rnn_gru_unit_block():
    """A DynamicRNN over ragged sequences, gru_unit in its block with an fc
    of the step input and a static input, inside a larger program: the
    block runs segmented around the islands."""
    H = 8

    def build(fluid):
        L, P = fluid.layers, fluid.ParamAttr
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = L.data("x", shape=[H], dtype="float32", lod_level=1)
            boot = L.data("boot", shape=[H], dtype="float32")
            hx = L.fc(L.fc(x, H, act="relu"), H)
            enc = L.fc(L.fc(boot, H, act="tanh"), H, act="tanh")
            drnn = L.DynamicRNN()
            with drnn.block():
                w = L.reshape(drnn.step_input(hx), [-1, H])
                c = L.reshape(drnn.static_input(enc), [-1, H])
                mem = drnn.memory(init=enc, need_reorder=True)
                g = L.fc([w, c], 3 * H, param_attr=[P(name="gx"),
                                                    P(name="gc")])
                h, _, _ = L.gru_unit(g, mem, 3 * H)
                drnn.update_memory(mem, h)
                drnn.output(h)
            out = L.reshape(drnn(), [-1, H])
            pooled = L.sequence_pool(L.fc(out, H, act="relu"), "sum")
        return main, startup, [out, pooled]
    rng = np.random.RandomState(0)
    lens = [3, 1, 4, 2]
    X = rng.rand(sum(lens), H).astype(np.float32)
    feed = {"x": (X, [list(np.cumsum([0] + lens))]),
            "boot": rng.rand(4, H).astype(np.float32)}
    _run_both(build, feed, steps=2)


def test_recurrent_op_direct():
    """The recurrent op run by the interpreter: a running sum over
    time-major input, forward and reversed."""
    for rev in (False, True):
        main = tfluid.Program()
        block = main.global_block()
        sub = main._create_block()
        main._rollback()
        sub.append_op(type="elementwise_add",
                      inputs={"X": ["x"], "Y": ["h@pre"]},
                      outputs={"Out": ["h"]}, attrs={"axis": -1})
        block.append_op(type="recurrent",
                        inputs={"inputs": ["x"], "initial_states": ["h0"],
                                "parameters": []},
                        outputs={"outputs": ["h"], "step_scopes": []},
                        attrs={"sub_block": sub, "ex_states": ["h@pre"],
                               "states": ["h"], "reverse": rev,
                               "has_states": True})
        T, B, D = 3, 2, 2
        x = np.arange(T * B * D, dtype=np.float32).reshape(T, B, D)
        scope = tfluid.Scope()
        scope.var("x").set_value(tfluid.LoDTensor(torch.from_numpy(x)))
        scope.var("h0").set_value(tfluid.LoDTensor(torch.zeros(B, D)))
        (o,) = tfluid.Executor(tfluid.CPUPlace()).run(main, fetch_list=["h"],
                                                      scope=scope)
        want = np.cumsum(x[::-1], 0)[::-1] if rev else np.cumsum(x, 0)
        np.testing.assert_array_equal(o, want)


# ------------------------------------------------------ StaticRNN
def test_static_rnn_cumsum_semantics():
    T, B, D = 4, 2, 3

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.data("x", shape=[T, B, D], dtype="float32",
                           append_batch_size=False)
            rnn = fluid.layers.StaticRNN()
            with rnn.step():
                x_t = rnn.step_input(x)
                mem = rnn.memory(shape=[-1, D], batch_ref=x_t)
                acc = fluid.layers.elementwise_add(mem, x_t)
                rnn.update_memory(mem, acc)
                rnn.step_output(acc)
            out = rnn()
        return main, startup, [out]
    X = np.random.RandomState(0).rand(T, B, D).astype("float32")
    (o,), _ = _run_both(build, {"x": X})
    np.testing.assert_allclose(o, np.cumsum(X, axis=0), rtol=RTOL)


def test_static_rnn_with_fc_trains():
    T, B, D, H = 3, 4, 5, 6

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.data("x", shape=[T, B, D], dtype="float32",
                           append_batch_size=False)
            y = fluid.data("y", shape=[B, 1], dtype="int64",
                           append_batch_size=False)
            rnn = fluid.layers.StaticRNN()
            with rnn.step():
                x_t = rnn.step_input(x)
                h_prev = rnn.memory(shape=[-1, H], batch_ref=x_t)
                h = fluid.layers.fc(fluid.layers.concat([x_t, h_prev], 1),
                                    H, act="tanh",
                                    param_attr=fluid.ParamAttr(
                                        name="rnn_fc_w"), bias_attr=False)
                rnn.update_memory(h_prev, h)
                rnn.step_output(h)
            seq = rnn()
            last = fluid.layers.squeeze(fluid.layers.slice(
                seq, axes=[0], starts=[T - 1], ends=[T]), [0])
            pred = fluid.layers.fc(last, 3, act="softmax")
            loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, y))
            fluid.optimizer.Adam(0.05).minimize(loss)
        return main, startup, [loss]
    rng = np.random.RandomState(1)
    _run_both(build, {"x": rng.rand(T, B, D).astype("float32"),
                      "y": rng.randint(0, 3, (B, 1)).astype("int64")},
              steps=4, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------ cells and rnn
@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("rev", [False, True], ids=["forward", "reverse"])
def test_cells_under_rnn_train(cell, rev):
    T, B, D, H = 4, 3, 5, 6

    def build(fluid):
        L = fluid.layers
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.data("x", shape=[T, D], dtype="float32")
            c = L.GRUCell(H) if cell == "gru" else L.LSTMCell(H)
            out, states = L.rnn(c, x, is_reverse=rev)
            last = states if cell == "gru" else states[1]
            loss = L.mean(L.elementwise_add(L.reduce_mean(out), last))
            fluid.optimizer.SGD(0.5).minimize(loss)
        return main, startup, [out, loss]
    rng = np.random.RandomState(2)
    _run_both(build, {"x": rng.rand(B, T, D).astype("float32")}, steps=3)


def test_cell_weights_shared_across_unrolled_steps():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.data("x", shape=[7, 5], dtype="float32")
        tfluid.layers.rnn(tfluid.layers.GRUCell(hidden_size=5), x)
    names = sorted(p.name for p in main.all_parameters())
    assert len(names) == 3, names
    assert len([n for n in names if n.endswith("_x")]) == 1
    assert len([n for n in names if n.endswith("_h")]) == 1


def test_cell_attrs_keep_user_fields():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.data("x", shape=[4, 5], dtype="float32")
        cell = tfluid.layers.GRUCell(
            hidden_size=5,
            param_attr=tfluid.ParamAttr(name="frozen_w", trainable=False))
        tfluid.layers.rnn(cell, x)
    frozen = [p for p in main.all_parameters()
              if p.name.startswith("frozen_w")]
    assert len(frozen) == 2 and not any(p.trainable for p in frozen)


# ------------------------------------------------------ decoding
def _decode_build(kind, V=7, H=8, T=5):
    def build(fluid):
        layers = fluid.layers
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            enc = fluid.data("enc", shape=[H], dtype="float32")
            cell = layers.GRUCell(hidden_size=H)

            def embedder(ids):
                return layers.embedding(
                    layers.reshape(ids, [-1, 1]), size=[V, H],
                    param_attr=fluid.ParamAttr(name="trg_emb"))

            def output_fn(x):
                return layers.fc(x, V,
                                 param_attr=fluid.ParamAttr(name="out_w"),
                                 bias_attr=False)
            if kind == "training":
                trg = fluid.data("trg_emb_seq", shape=[T, H],
                                 dtype="float32")
                trg_len = fluid.data("trg_len", shape=[], dtype="int64")
                helper = layers.TrainingHelper(trg, trg_len)
            else:
                start = fluid.data("start", shape=[], dtype="int64")
                helper = layers.GreedyEmbeddingHelper(
                    lambda ids: layers.squeeze(embedder(ids), [1]), start, 1)
            decoder = layers.BasicDecoder(cell, helper, output_fn=output_fn)
            outs, _, lens = layers.dynamic_decode(
                decoder, inits=enc, max_step_num=T, return_length=True)
        return main, startup, [outs.cell_outputs, outs.sample_ids, lens]
    return build


@pytest.mark.parametrize("kind", ["training", "greedy"])
def test_basic_decoder_helpers(kind):
    V, H, B, T = 7, 8, 3, 5
    rng = np.random.RandomState(0)
    feed = {"enc": rng.rand(B, H).astype("float32")}
    if kind == "training":
        feed["trg_emb_seq"] = rng.rand(B, T, H).astype("float32")
        feed["trg_len"] = np.array([T, 2, 4], "int64")
    else:
        feed["start"] = np.zeros((B,), "int64")
    (co, ids, lens), _ = _run_both(_decode_build(kind, V, H, T), feed,
                                   exact=(1, 2))
    assert co.shape == (B, T, V)
    np.testing.assert_array_equal(ids, co.argmax(-1))


def test_sample_embedding_helper_draws_in_range():
    V, H, B, T = 7, 8, 3, 5
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        layers = tfluid.layers
        enc = tfluid.data("enc", shape=[H], dtype="float32")
        start = tfluid.data("start", shape=[], dtype="int64")
        helper = layers.SampleEmbeddingHelper(
            lambda ids: layers.squeeze(layers.embedding(
                layers.reshape(ids, [-1, 1]), size=[V, H]), [1]), start, 1,
            softmax_temperature=2.0, seed=7)
        outs, _ = layers.dynamic_decode(
            layers.BasicDecoder(layers.GRUCell(H), helper,
                                output_fn=lambda x: layers.fc(x, V)),
            inits=enc, max_step_num=T)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    co, ids = exe.run(main, feed={"enc": rng.rand(B, H).astype("float32"),
                                  "start": np.zeros((B,), "int64")},
                      fetch_list=[outs.cell_outputs, outs.sample_ids],
                      scope=scope)
    assert co.shape == (B, T, V) and ids.shape == (B, T)
    assert ids.min() >= 0 and ids.max() < V


def test_dynamic_decode_beam_search():
    V, E, H, B = 7, 4, 6, 2

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            enc = fluid.data("enc", shape=[H], dtype="float32")
            cell = fluid.layers.GRUCell(hidden_size=H)
            dec = fluid.layers.BeamSearchDecoder(
                cell, start_token=1, end_token=2, beam_size=3,
                embedding_fn=lambda ids: fluid.layers.embedding(
                    ids, size=[V, E],
                    param_attr=fluid.ParamAttr(name="dec_emb")),
                output_fn=lambda h: fluid.layers.fc(
                    h, V, param_attr=fluid.ParamAttr(name="dec_out_w"),
                    bias_attr=False, name="dec_out"))
            pred, scores = fluid.layers.dynamic_decode(dec, inits=enc,
                                                       max_step_num=5)
        return main, startup, [pred, scores]
    rng = np.random.RandomState(5)
    (p, s), _ = _run_both(build, {"enc": rng.randn(B, H).astype(np.float32)},
                          exact=(0,))
    assert p.shape == (B, 5, 3) and s.shape == (B, 3)
    assert (np.diff(s, axis=1) <= 1e-6).all()


# ------------------------------------------------------ contrib decoder
def test_training_decoder_gru_like():
    T, B, D, H = 4, 2, 3, 5
    rng = np.random.RandomState(0)
    X = rng.rand(T, B, D).astype("float32")
    H0 = rng.rand(B, H).astype("float32")

    def build(fluid):
        from importlib import import_module
        dec = import_module(fluid.__name__ + ".contrib.decoder")
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.data("x", shape=[T, B, D], dtype="float32",
                           append_batch_size=False)
            h0 = fluid.data("h0", shape=[B, H], dtype="float32",
                            append_batch_size=False)
            cell = dec.StateCell(inputs={"x": None},
                                 states={"h": dec.InitState(init=h0)},
                                 out_state="h")

            @cell.state_updater
            def updater(c):
                h = fluid.layers.fc(
                    fluid.layers.concat([c.get_input("x"), c.get_state("h")],
                                        axis=1), H, act="tanh",
                    param_attr=fluid.ParamAttr(name="w"), bias_attr=False)
                c.set_state("h", h)

            decoder = dec.TrainingDecoder(cell)
            with decoder.block():
                cell.compute_state({"x": decoder.step_input(x)})
                decoder.output(cell.out_state())
            outs = decoder()
        return main, startup, [outs, "w"]
    (got, w), _ = _run_both(build, {"x": X, "h0": H0})
    h, expect = H0, []
    for t in range(T):
        h = np.tanh(np.concatenate([X[t], h], axis=1) @ w)
        expect.append(h)
    np.testing.assert_allclose(got, np.stack(expect), rtol=RTOL, atol=ATOL)


def test_state_cell_errors():
    from paddle_tpu_torch.fluid.contrib.decoder import StateCell
    cell = StateCell({"x": None}, {}, "h")
    with pytest.raises(ValueError):
        cell.get_input("x")
    with pytest.raises(ValueError):
        cell.get_state("h")
    with pytest.raises(RuntimeError):
        cell.compute_state({"x": 1})


def test_decode_needs_embedding_and_scoring():
    from paddle_tpu_torch.fluid.contrib.decoder import (BeamSearchDecoder,
                                                        InitState, StateCell)
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        ids = tfluid.data("i", shape=[1], dtype="int64", lod_level=2)
        sc = tfluid.data("s", shape=[1], dtype="float32", lod_level=2)
        h = tfluid.data("h", shape=[4], dtype="float32")
        cell = StateCell({"x": None}, {"h": InitState(init=h)}, "h")
        bsd = BeamSearchDecoder(cell, ids, sc, target_dict_dim=8,
                                word_dim=4)
        with pytest.raises(RuntimeError, match="embedding"):
            bsd.decode()
