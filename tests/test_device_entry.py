"""How the program reaches the device: the `--device` label, the refusal
of a CPU backend nobody asked for, the compile cache's directory, and
chip_smoke.py's refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys

import pytest

from linear_tpu import cli
from linear_tpu.utils import jaxcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("device,ok", [("accel", True), ("host", True),
                                       ("tpu", False)])
def test_device_choice(device, ok):
    argv = ["filter", "r.fa", "g.fa", "--device", device]
    if ok:
        assert cli.build_parser().parse_args(argv).device == device
    else:
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(argv)


@pytest.mark.parametrize("platforms,ok", [("cpu", True), (None, False),
                                          ("cuda,cpu", False)])
def test_accel_device_refuses_unrequested_cpu(monkeypatch, platforms, ok):
    """The tests' backend is the CPU: accepted for --device accel only when
    JAX_PLATFORMS names the CPU alone (JAX's silent CPU fallback must not
    pass as a device run)."""
    if platforms is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", platforms)
    if ok:
        assert jaxcfg.accel_device().platform == "cpu"
    else:
        with pytest.raises(RuntimeError, match="no accelerator"):
            jaxcfg.accel_device()


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_dir(tmp_path, env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(ROOT, ".jax_cache")
    if env_dir:
        want = str(tmp_path / "cc")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    code = ("import jax\nfrom linear_tpu.ops import seeding\n"
            "print(jax.config.jax_compilation_cache_dir)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == want
    assert os.path.isdir(want)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """On the CPU backend, and in a directory without the rest of the repo,
    chip_smoke.py fails fast and prints no result."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        cwd = str(tmp_path)
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
