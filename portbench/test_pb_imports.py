"""The import rule: nothing under portbench/ imports JAX, jaxlib, flax or the
JAX package (top-level names compared whole, so the port,
``unet_implementations_tpu_torch``, is allowed in the harness), and the
plain reference imports nothing of the port either."""

import ast
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from pb import guard  # noqa: E402

PORT = "unet_implementations_tpu_torch"
SOURCES = sorted(p for p in HERE.rglob("*.py") if "_cache" not in p.parts)


def imported(path: Path):
    """Every module name that ``path`` imports, at any depth of its code."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            names.append(node.args[0].value)
    return names


def test_whole_top_level_names():
    assert guard.forbidden(["unet_implementations_tpu_torch.models.unet"]) == set()
    assert guard.forbidden(["unet_implementations_tpu.models.unet"]) == {"unet_implementations_tpu"}
    assert guard.forbidden(["jax.numpy", "jaxlib", "flax.linen", "jaxtyping"]) == {
        "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(HERE).as_posix())
def test_no_forbidden_import(path):
    assert guard.forbidden(imported(path)) == set()


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = {guard.top_level(n) for n in imported(path)}
    assert PORT not in tops and not (tops & guard.FORBIDDEN)
    assert "pb" not in tops or path.name == "clip.py"


def test_a_run_loads_nothing_forbidden(tmp_path):
    """A whole tiny run in a fresh process, then its modules."""
    import subprocess
    code = (
        "import sys, time, torch; sys.path[:0] = [%r, %r]\n"
        "from pathlib import Path\n"
        "from pb import tiny, runner, guard\n"
        "root = tiny.write(Path(%r))\n"
        "runner.run_cell(tiny.cell(root, 'tiny-predict'), 7, 0.3, False, torch.device('cpu'),"
        " time.perf_counter())\n"
        "assert 'unet_implementations_tpu_torch' in sys.modules\n"
        "print(sorted(guard.loaded_forbidden()))\n" % (str(HERE), str(HERE.parent), str(tmp_path)))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip().splitlines()[-1] == "[]"
