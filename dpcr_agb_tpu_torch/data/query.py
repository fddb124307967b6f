"""A label table's row filter from a pandas query string (the area option
`label_query`; the JAX package calls `DataFrame.query`). The GPU machine
has no pandas, so this copies the route of pandas' own parser:
  1. names in back quotes become identifiers (`clean_backtick_quoted_toks`);
  2. the tokens `&` and `|` become `and` and `or`, which gives them the
     precedence that pandas gives them (`_replace_booleans`): below the
     comparisons, so `a > 1 & b < 2` is `(a > 1) & (b < 2)`;
  3. `ast` parses the expression;
  4. a whitelist of nodes is evaluated on the table's numpy columns:
     comparisons (chained ones are the `and` of their links), `==` and
     `!=` against a list (membership, as pandas reads them), `in` and
     `not in`, `and`, `or`, `not` and `~`, `+ - * /`, unary minus and
     plus, number, string and bool literals, lists and tuples of them, and
     column names.
Anything else raises and names the node: `@` locals, calls, attributes,
subscripts. Comparisons with NaN follow numpy (as pandas does): False,
and True for `!=`. The mask keeps the rows in their order."""
from __future__ import annotations

import ast
import io
import re
import tokenize

import numpy as np

_BACKTICK = re.compile(r"`([^`]*)`")
_CMP = {ast.Eq: np.equal, ast.NotEq: np.not_equal, ast.Lt: np.less,
        ast.LtE: np.less_equal, ast.Gt: np.greater,
        ast.GtE: np.greater_equal}
_ARITH = {ast.Add: np.add, ast.Sub: np.subtract, ast.Mult: np.multiply,
          ast.Div: np.true_divide}


def _rewrite(expr: str):
    """(source for `ast`, {identifier: column name}) after steps 1-2."""
    names = {}

    def quoted(m):
        ident = f"BACKTICK_QUOTED_STRING_{len(names)}"
        names[ident] = m.group(1)
        return ident

    src = _BACKTICK.sub(quoted, expr)
    toks = []
    for tok in tokenize.generate_tokens(io.StringIO(src).readline):
        if tok.type == tokenize.OP and tok.string in ("&", "|"):
            toks.append((tokenize.NAME, "and" if tok.string == "&" else "or"))
        elif tok.type == tokenize.OP and tok.string == "@":
            raise NotImplementedError(
                f"label_query {expr!r}: '@' locals are not supported (the "
                "query reads the label table's columns only)")
        else:
            toks.append((tok.type, tok.string))
    return tokenize.untokenize(toks), names


class _Eval:
    def __init__(self, table, names: dict, expr: str):
        self.table, self.names, self.expr = table, names, expr

    def fail(self, node):
        raise NotImplementedError(
            f"label_query {self.expr!r}: {type(node).__name__} is not "
            "supported (columns, literals, comparisons, in / not in, and / "
            "or / not / ~, + - * /)")

    def __call__(self, node):
        if isinstance(node, ast.Expression):
            return self(node.body)
        if isinstance(node, ast.BoolOp):
            values = [self(v) for v in node.values]
            op = np.logical_and if isinstance(node.op, ast.And) \
                else np.logical_or
            out = values[0]
            for v in values[1:]:
                out = op(out, v)
            return out
        if isinstance(node, ast.UnaryOp):
            v = self(node.operand)
            if isinstance(node.op, ast.Not) or (
                    isinstance(node.op, ast.Invert)
                    and np.asarray(v).dtype == bool):
                return np.logical_not(v)
            if isinstance(node.op, ast.Invert):
                return np.invert(v)
            if isinstance(node.op, ast.USub):
                return np.negative(v)
            if isinstance(node.op, ast.UAdd):
                return np.positive(v)
            self.fail(node.op)
        if isinstance(node, ast.BinOp):
            fn = _ARITH.get(type(node.op))
            if fn is None:
                self.fail(node.op)
            return fn(self(node.left), self(node.right))
        if isinstance(node, ast.Compare):
            out, left = None, self(node.left)
            for op, comp in zip(node.ops, node.comparators):
                right = self(comp)
                link = self.compare(op, left, right)
                out = link if out is None else np.logical_and(out, link)
                left = right
            return out
        if isinstance(node, ast.Name):
            col = self.names.get(node.id, node.id)
            if col not in self.table:
                raise ValueError(f"label_query {self.expr!r}: name {col!r} "
                                 "is not a column of the label table")
            return self.table[col]
        if isinstance(node, ast.Constant) and isinstance(
                node.value, (bool, int, float, str)):
            return node.value
        if isinstance(node, (ast.List, ast.Tuple)):
            return [self(e) for e in node.elts]
        self.fail(node)

    def compare(self, op, left, right):
        if isinstance(op, (ast.In, ast.NotIn)) or (
                isinstance(op, (ast.Eq, ast.NotEq))
                and isinstance(right, list)):
            if not isinstance(right, list):
                self.fail(op)
            hit = np.isin(np.asarray(left), np.asarray(right, dtype=object)
                          if any(isinstance(r, str) for r in right)
                          else np.asarray(right))
            return np.logical_not(hit) \
                if isinstance(op, (ast.NotIn, ast.NotEq)) else hit
        fn = _CMP.get(type(op))
        if fn is None:
            self.fail(op)
        with np.errstate(invalid="ignore"):
            return fn(left, right)


def query_mask(table, expr: str) -> np.ndarray:
    """The rows of `table` (a `data.table.Table`) that `expr` selects, as a
    bool mask in row order."""
    src, names = _rewrite(expr)
    tree = ast.parse(src.strip(), mode="eval")
    mask = np.asarray(_Eval(table, names, expr)(tree))
    if mask.dtype != bool or mask.shape != (len(table),):
        raise ValueError(f"label_query {expr!r} gives {mask.dtype} of shape "
                         f"{mask.shape}, not one bool a row")
    return mask
