"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the reference loads no part of the program."""

import ast
import importlib.util
import sys

from slambench import spec


def _run_module():
    s = importlib.util.spec_from_file_location("slambench_run_cli", spec.BENCH_DIR / "run.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    run = _run_module()
    for name in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "stereoslam_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "stereoslam_tpu.config", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert run.forbidden_modules() == ["jaxlib", "stereoslam_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_sources_import_neither_jax_nor_the_jax_package():
    for path in spec.BENCH_DIR.rglob("*.py"):
        if "tests" in path.relative_to(spec.BENCH_DIR).parts:
            continue
        names = set(_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "stereoslam_tpu"}, path
        if "reference" in path.parts or "traffic" in path.parts or "roofline" in path.parts:
            assert "stereoslam_tpu_torch" not in names or path.name == "lk_probe.py", path
