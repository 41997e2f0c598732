"""The port's metric lint (the counterpart of
``tests/observability/test_metric_names_lint.py``): every metric name,
trace name and stall kind emitted under ``areal_tpu_torch/`` is a literal
in the port's canonical tables, and every label set passed where the
metric is known at the call site is the table's, so the registry's label
check (``observability/registry.py``) cannot stop a worker at run time.
The collectors are the JAX package's lint (``scripts/check_metric_names.py``)
pointed at the port's files."""

import ast
import os
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO_ROOT, "areal_tpu_torch")
_METHODS = ("counter", "gauge", "histogram")
_WRITES = ("inc", "set", "observe")


def _port_files():
    out = []
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.fixture
def lint(monkeypatch):
    sys.path.insert(0, os.path.join(REPO_ROOT, "scripts"))
    try:
        import check_metric_names as mod
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(mod, "_iter_source_files", _port_files)
    return mod


def test_every_emitted_metric_name_is_in_the_ports_table(lint):
    from areal_tpu_torch.observability.table import table_index

    table = table_index()
    emitted = lint.collect_emitted_names()
    assert "<non-literal>" not in emitted, emitted.get("<non-literal>")
    unknown = {n: sites for n, sites in emitted.items() if n not in table}
    assert not unknown, unknown
    assert len(emitted) > 60  # the lint sees the port's emissions


def test_every_trace_name_and_stall_kind_is_in_the_ports_tables(lint):
    from areal_tpu_torch.observability.table import (
        STALL_KINDS,
        trace_table_index,
    )

    traces = lint.collect_trace_names()
    traces.pop("<non-literal>", None)  # tracer helpers forward a name
    unknown = {n: s for n, s in traces.items() if n not in trace_table_index()}
    assert not unknown, unknown
    kinds = lint.collect_stall_kind_sites()
    assert "<non-literal>" not in kinds
    assert set(kinds) <= set(STALL_KINDS) and "recompile" in kinds


def _metric_of(node):
    """The literal metric name of ``x.counter("name")``-shaped calls."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in _METHODS and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)):
        return node.args[0].value
    return None


def _target_key(node):
    """A name or a ``self.attr`` / ``self.attr["key"]`` target, as a key."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        inner = _target_key(node.value)
        return None if inner is None else f"{inner}.{node.attr}"
    if (isinstance(node, ast.Subscript) and isinstance(node.slice, ast.Constant)):
        inner = _target_key(node.value)
        return None if inner is None else f"{inner}[{node.slice.value!r}]"
    return None


def label_sites(path):
    """``[(lineno, metric, label keys or None)]`` of every write whose metric
    is known at the call site: a chained ``reg.counter("x").inc(...)``, or
    a write through a name, an attribute or a dict entry the same file
    bound to one (``self._obs = {"k": reg.counter("x")}`` included).
    ``None`` labels: a ``**`` mapping that is not a dict literal."""
    with open(path) as f:
        tree = ast.parse(f.read())
    bound = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            key = _target_key(tgt)
            if key is None:
                continue
            name = _metric_of(node.value)
            if name is not None:
                bound[key] = name
            elif isinstance(node.value, ast.Dict):
                for k, v in zip(node.value.keys, node.value.values):
                    name = _metric_of(v)
                    if name is not None and isinstance(k, ast.Constant):
                        bound[f"{key}[{k.value!r}]"] = name
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _WRITES):
            continue
        recv = node.func.value
        name = _metric_of(recv) or bound.get(_target_key(recv))
        if name is None:
            continue
        keys = set()
        for kw in node.keywords:
            if kw.arg is not None:
                keys.add(kw.arg)
            elif isinstance(kw.value, ast.Dict) and all(
                    isinstance(k, ast.Constant) for k in kw.value.keys):
                keys |= {k.value for k in kw.value.keys}
            else:
                keys = None
                break
        out.append((node.lineno, name, keys))
    return out


def test_every_label_set_at_a_known_site_is_the_tables():
    from areal_tpu_torch.observability.table import table_index

    table = table_index()
    bad, n = [], 0
    for path in _port_files():
        for lineno, name, keys in label_sites(path):
            spec = table.get(name)
            if spec is None or keys is None:
                continue
            n += 1
            if keys != set(spec.labels):
                bad.append(f"{os.path.relpath(path, REPO_ROOT)}:{lineno} "
                           f"{name} labels {sorted(keys)}, table "
                           f"{sorted(spec.labels)}")
    assert not bad, bad
    assert n > 40  # the label pass reaches the port's write sites


def test_the_label_lint_catches_a_wrong_label(tmp_path):
    src = tmp_path / "mod.py"
    src.write_text(
        "self._obs = {'x': reg.counter('areal_xla_compiles_total')}\n"
        "self._obs['x'].inc(kind='a')\n"
        "g = reg.gauge('areal_hbm_ledger_bytes')\n"
        "g.set(1.0, subsystem='kv_pool')\n"
        "reg.counter('areal_gateway_preemptions_total').inc(**{'class': 'b'})\n"
    )
    assert label_sites(str(src)) == [
        (2, "areal_xla_compiles_total", {"kind"}),
        (4, "areal_hbm_ledger_bytes", {"subsystem"}),
        (5, "areal_gateway_preemptions_total", {"class"}),
    ]
