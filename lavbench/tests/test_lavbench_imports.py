"""Nothing the benchmark runs has the top-level name `jax`, `jaxlib`,
`flax` or `lav_tpu` (compared whole: `lav_tpu_torch` is the port), in a
run's process or in its sources; the reference imports nothing of the
port."""

import ast
import subprocess
import sys
import textwrap

from lavbench.tests.helpers import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "lav_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def test_sources_import_no_jax():
    for path in (REPO / "lavbench").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    for path in (REPO / "lavbench" / "ref").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "lav_tpu_torch" not in tops, path


def test_a_run_loads_no_jax(tmp_path):
    code = textwrap.dedent(f"""
        import io, sys
        sys.path.insert(0, {str(REPO)!r})
        import torch
        torch.set_num_threads(2)
        from lavbench.tests.helpers import tiny_root
        from lavbench import run
        root = tiny_root({str(tmp_path / "checkout")!r})
        rc = run.main(["--workload", "agent.int8.e16", "--seed", "5",
                       "--seconds", "0.3", "--trace", "1"], root=root,
                      device="cpu", out=io.StringIO())
        print("RC", rc)
        print("MODS", sorted({{m.split(".")[0] for m in sys.modules}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path)).stdout
    mods = eval(out.split("MODS", 1)[1].strip())
    assert "RC 0" in out and "lav_tpu_torch" in mods
    assert not set(mods) & FORBIDDEN


def test_forbidden_is_compared_whole():
    from lavbench import run

    sys.modules["lav_tpu_torch_fake_probe"] = sys
    try:
        assert "lav_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["lav_tpu_torch_fake_probe"]
