"""The port stands alone: no JAX, no ``repro`` import, no process-wide
torch state changed at import, and entry points that default to the card.
"""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_port_has_sources_for_its_kernels():
    csrc = {p.stem for p in (PORT / "csrc").glob("*.cu")}
    assert csrc == {"quantize_act", "qmatmul_w8a8", "qmatmul_w8a16",
                    "kv_attention", "fused_decode"}


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT),
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_import_leaves_jax_out_and_torch_state_alone():
    out = _run(
        "import sys, torch\n"
        "before = (torch.get_default_dtype(), torch.get_num_threads(),\n"
        "          torch.are_deterministic_algorithms_enabled())\n"
        "import repro_torch, repro_torch.serving, repro_torch.kernels\n"
        "import repro_torch.launch.serve, repro_torch.weights\n"
        "import repro_torch.core, repro_torch.pipeline\n"
        "import repro_torch.launch.train, repro_torch.launch.steps\n"
        "import repro_torch.runtime, repro_torch.optim, repro_torch.data\n"
        "import repro_torch.sharding, repro_torch.sharding.collectives\n"
        "import repro_torch.sharding.tp, repro_torch.launch.mesh\n"
        "import repro_torch.serving.mesh_control\n"
        "after = (torch.get_default_dtype(), torch.get_num_threads(),\n"
        "         torch.are_deterministic_algorithms_enabled())\n"
        "print(before == after, 'jax' in sys.modules, 'repro' in sys.modules)")
    assert out == "True False False"


def test_import_reads_no_backend_environment():
    """The port selects kernels by device only: importing it with the JAX
    package's switches set changes nothing, and it never writes them."""
    out = _run(
        "import os\n"
        "os.environ['REPRO_KERNEL_BACKEND'] = 'pallas'\n"
        "os.environ['REPRO_FUSED_DECODE'] = '0'\n"
        "snap = dict(os.environ)\n"
        "import torch, repro_torch\n"
        "from repro_torch.kernels import dispatch\n"
        "print(dispatch.tier_for(torch.zeros(1)), dict(os.environ) == snap)")
    assert out == "torch True"


def test_sharding_modules_are_the_ports_own():
    """The planner, the collectives, the shard and the mesh are the port's
    own copies: present, parsed by the import check above, and importing
    torch.distributed at most (no process group is started at import)."""
    for rel in ("sharding/__init__.py", "sharding/partition.py",
                "sharding/collectives.py", "sharding/tp.py",
                "launch/mesh.py", "serving/mesh_control.py"):
        path = PORT / rel
        assert path in _port_files(), rel
        assert not {n.split(".")[0] for n in _imports(path)} & {
            "jax", "jaxlib", "repro"}, rel
    out = _run("import torch.distributed as dist, repro_torch.sharding.tp, "
               "repro_torch.launch.mesh, repro_torch.launch.serve, "
               "repro_torch.serving.mesh_control\n"
               "print(dist.is_initialized())")
    assert out == "False"


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the defaults are valid")
    import repro_torch
    from repro_torch.models import build_model

    model = build_model(repro_torch.get_config("qwen2-0.5b-smoke"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    params = model.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.ServingEngine(model, params, model.cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.serve(repro_torch.ServeConfig(smoke=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(1, 8)
