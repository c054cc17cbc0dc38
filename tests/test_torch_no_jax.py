"""The port imports ``torch`` and never ``jax``: no module of
``lightgrad_tpu_torch`` names jax or the JAX package in an import, and
importing the whole package loads neither."""

import ast
import pathlib
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "lightgrad_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "lightgrad_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_module_imports_no_jax(path):
    bad = [m for m in _imports(path)
           if m and m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, lightgrad_tpu_torch, lightgrad_tpu_torch.models."
            "bert, lightgrad_tpu_torch.quant, lightgrad_tpu_torch.data, "
            "lightgrad_tpu_torch.models.resnet, lightgrad_tpu_torch.ops.conv, "
            "lightgrad_tpu_torch.models.llama, "
            "lightgrad_tpu_torch.models.neox, "
            "lightgrad_tpu_torch.utils.fetch, "
            "lightgrad_tpu_torch.examples.bert, "
            "lightgrad_tpu_torch.examples.diffusion, "
            "lightgrad_tpu_torch.examples.distributed, "
            "lightgrad_tpu_torch.examples.gpt, "
            "lightgrad_tpu_torch.examples.gradient_descent, "
            "lightgrad_tpu_torch.examples.llama, "
            "lightgrad_tpu_torch.examples.mnist, "
            "lightgrad_tpu_torch.examples.resnet, "
            "lightgrad_tpu_torch.examples.serving, "
            "lightgrad_tpu_torch.examples.t5; bad = [m for m in sys.modules "
            "if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lightgrad_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
