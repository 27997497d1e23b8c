"""The port stands alone: nothing under ``src/repro_torch`` (or
``chip_smoke.py``) imports JAX or the reference package, and the port
neither calls a library attention kernel nor compiles its plain code."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py", REPO / "tools" / "kernel_ab.py"]


def test_files_cover_the_hybrid_slice():
    names = {p.name for p in FILES}
    assert {"ssm.py", "selective_scan.py", "hymba_1_5b.py"} <= names


def test_files_cover_the_serving_stack():
    names = {p.name for p in FILES}
    assert {"scheduler.py", "router.py", "server.py", "client.py",
            "faults.py", "supervisor.py", "metrics.py", "tracing.py",
            "worker.py", "serve.py"} <= names


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


def test_port_uses_no_library_attention_or_compile():
    for path in (REPO / "src" / "repro_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        attrs = {n.attr for n in ast.walk(tree)
                 if isinstance(n, ast.Attribute)}
        assert not attrs & {"scaled_dot_product_attention", "compile",
                            "topk"}, path


def test_port_imports_and_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import torch\n"
        "import repro_torch, repro_torch.serving, repro_torch.convert\n"
        "import repro_torch.serving.server, repro_torch.serving.scheduler\n"
        "import repro_torch.serving.router, repro_torch.serving.client\n"
        "import repro_torch.serving.worker, repro_torch.launch.serve\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models import forward, init_model\n"
        "for name in ('llada-8b-tiny', 'hymba-1.5b-tiny'):\n"
        "    cfg = get_config(name)\n"
        "    p = init_model(cfg, device='cpu')\n"
        "    out = forward(p, torch.zeros(1, 8, dtype=torch.long), cfg)\n"
        "    assert out.shape == (1, 8, cfg.vocab_size)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_a_card():
    """Without CUDA the smoke exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
