"""Painless score scripts of opensearch_tpu_torch held against
opensearch_tpu: the tokenizer and parser give the same AST (class names
and fields) and the same errors, and `TorchScoreScript` computes what
`JaxScoreScript` computes on the same random columns, scores and params:
every operator, every Math function and constant, ternaries, elvis-free
expressions over `params.x` / `params['x']`, `doc['f'].value`, `.empty`
and `.size()`, `_score`, returns, and the errors of statement scripts,
missing params and fields.

Contract: the same dtype class (bool / integer / float) and shape after
broadcasting; integers and booleans exactly; floats to rtol 2e-6 with
atol 1e-6 (XLA's and PyTorch's CPU transcendental functions may differ by
an ulp or two), NaN and inf where the reference has them."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.common.errors import OpenSearchTpuError as JError
from opensearch_tpu.script import painless as jp

from opensearch_tpu_torch.common.errors import OpenSearchTpuError as TError
from opensearch_tpu_torch.script import painless as tp

SOURCES = [
    "1 + 2 * 3 - 4 / 5 % 3",
    "_score * 2 + 1",
    "return doc['a'].value * params.f;",
    "doc['a'].value > 3 ? doc['b'].value : params['g']",
    "doc['a'].empty ? 0 : doc['a'].size() + doc['b'].size() * 2",
    "!(doc['a'].value <= 1) && doc['b'].value >= -2 || _score == 0",
    "doc['a'].value != doc['b'].value ? 1.5 : -2.5",
    "-doc['a'].value % 3 + doc['b'].value % -2.5",
    "Math.log(2) * Math.log10(1 + Math.abs(doc['a'].value))",
    "Math.exp(doc['b'].value / 10) + Math.sqrt(Math.abs(_score))",
    "Math.max(doc['a'].value, 1) - Math.min(doc['b'].value, params.f)",
    "Math.pow(Math.abs(doc['a'].value), 1.5) + Math.floor(doc['b'].value)",
    "Math.ceil(doc['a'].value) + Math.round(doc['b'].value * 2.5)",
    "Math.sin(doc['a'].value) + Math.cos(_score) - Math.tan(0.5)",
    "Math.PI * Math.E + Math.log(doc['a'].value)",
    "_score * Math.log(2 + doc['a'].value)",
    "10L + 2.5f - .5 + 3d",
    "doc['a'].size() / 2 + doc['a'].size() % 2",
    "params.f > 1 ? Math.round(2.5) : Math.round(3.5)",
]
STATEMENT_SOURCES = [
    "def x = 1; x += 2; return x;",
    "if (a > 1) { return 1 } else { return 2 }",
    "for (def i = 0; i < 3; i++) { s += i }",
    "for (x in params.list) { y.add(x) }",
    "while (x < 3) { x++ }",
    "ctx._source.n = [1, 2, 3]; ctx._source.m = [:]",
    "def l = new ArrayList(); l.add('x'); return l.size()",
    "x ?: y",
]
BAD_SOURCES = ["1 +", "doc['a'.value", "a = ", "@", "new Thing()",
               "(1 + 2", "x ? 1", "1 ++ 2", "['k': 1]"]


def _ast(node):
    """An AST as plain data: (class name, fields) all the way down."""
    if isinstance(node, (list, tuple)):
        return type(node).__name__, [_ast(n) for n in node]
    if dataclasses.is_dataclass(node):
        return type(node).__name__, {f.name: _ast(getattr(node, f.name))
                                     for f in dataclasses.fields(node)}
    return node


@pytest.mark.parametrize("src", SOURCES + STATEMENT_SOURCES)
def test_parser_gives_the_same_ast(src):
    assert jp.tokenize(src) == tp.tokenize(src)
    assert _ast(jp.parse(src)) == _ast(tp.parse(src))
    assert jp.collect_doc_fields(jp.parse(src)) == \
        tp.collect_doc_fields(tp.parse(src))


@pytest.mark.parametrize("src", BAD_SOURCES)
def test_parser_gives_the_same_errors(src):
    with pytest.raises(JError) as want:
        jp.parse(src)
    with pytest.raises(TError) as got:
        tp.parse(src)
    assert type(got.value).__name__ == type(want.value).__name__
    assert got.value.reason == want.value.reason
    assert got.value.status == want.value.status == 400


def _inputs(seed: int, d: int = 64):
    rng = np.random.default_rng(seed)
    cols = {}
    for f in ("a", "b"):
        vals = rng.normal(0, 4, d).astype(np.float32)
        vals[::9] = 0.0
        exists = rng.random(d) < 0.8
        counts = np.where(exists, rng.integers(1, 3, d), 0).astype(np.int32)
        cols[f] = (vals, exists, counts)
    score = rng.uniform(0, 9, d).astype(np.float32)
    score[::11] = 0.0
    return cols, score, {"f": np.float32(1.75), "g": np.float32(-0.5)}


def _run_both(src, seed=0):
    cols, score, params = _inputs(seed)
    want = jp.JaxScoreScript(src)(
        {f: tuple(jnp.asarray(x) for x in c) for f, c in cols.items()},
        jnp.asarray(score), {k: jnp.asarray(v) for k, v in params.items()})
    got = tp.TorchScoreScript(src)(
        {f: tuple(torch.from_numpy(x) for x in c) for f, c in cols.items()},
        torch.from_numpy(score),
        {k: torch.tensor(v) for k, v in params.items()})
    return got, want


@pytest.mark.parametrize("src", SOURCES)
@pytest.mark.parametrize("seed", [0, 1])
def test_torch_script_equals_jax_script(src, seed):
    got, want = _run_both(src, seed)
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape or np.broadcast_shapes(
        got.shape, want.shape) == want.shape
    got = np.broadcast_to(got, want.shape)
    if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        assert got.dtype.kind == want.dtype.kind
        np.testing.assert_array_equal(got, want)
    else:
        assert got.dtype.kind == "f"
        np.testing.assert_allclose(got.astype(np.float32), want, rtol=2e-6,
                                   atol=1e-6, equal_nan=True)


def test_script_fields_and_memo():
    s = tp.compile_score_script("doc['x'].value + doc['y'].size()")
    assert s.fields == ["x", "y"]
    assert tp.compile_score_script("doc['x'].value + doc['y'].size()") is s


@pytest.mark.parametrize("src,cols,params", [
    ("def x = 1; return x;", {}, {}),
    ("params.nope * 2", {}, {}),
    ("params['nope']", {}, {}),
    ("doc['zz'].value", {}, {}),
    ("ctx.x", {}, {}),
    ("Math.hypot(1, 2)", {}, {}),
    ("doc['a'].foo()", {"a": 1}, {}),
    ("doc.a", {}, {}),
    ("'str' == 'str' ? 1 : 0", {}, {}),
], ids=["statements", "missing_param", "missing_param_index",
        "missing_field", "unknown_variable", "unknown_math", "bad_method",
        "bad_doc_access", "string_literal"])
def test_script_errors_equal_reference(src, cols, params):
    col = (np.zeros(4, np.float32), np.ones(4, bool), np.ones(4, np.int32))
    with pytest.raises(JError) as want:
        jp.JaxScoreScript(src)({f: tuple(jnp.asarray(x) for x in col)
                                for f in cols}, jnp.zeros(4), params)
    with pytest.raises(TError) as got:
        tp.TorchScoreScript(src)({f: tuple(torch.from_numpy(x) for x in col)
                                  for f in cols}, torch.zeros(4), params)
    assert got.value.reason == want.value.reason
    assert got.value.error_type == want.value.error_type
