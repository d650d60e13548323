"""The port's kernel build (``ops/_build.py``) without a CUDA toolkit: a
stand-in ``nvcc`` shows the command line, the digest-keyed build directory,
the reuse of a finished build and the error a failed build raises.  The
real build and the kernels run on the card (``chip_smoke.py``)."""

import stat
import sys

import pytest

from spatiotemporal_variable_separation_tpu_torch.ops import _build

FAKE_NVCC = """#!{python}
import sys
from pathlib import Path
args = sys.argv[1:]
log = Path({log!r})
log.write_text(log.read_text() + " ".join(args) + "\\n" if log.exists() else " ".join(args) + "\\n")
if {fail!r}:
    sys.stderr.write("error: expected a ';' at mlp_resnet_rollout.cu:42\\n")
    sys.exit(2)
Path(args[args.index("-o") + 1]).write_bytes(b"not really a library")
sys.stderr.write("ptxas info    : Used 40 registers\\n")
"""


def _fake_nvcc(tmp_path, monkeypatch, fail=False):
    script = tmp_path / "nvcc"
    log = tmp_path / "calls.log"
    script.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log), fail=fail))
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(script))
    return log


def test_build_compiles_each_source_once_for_sm_90a(tmp_path, monkeypatch):
    log = _fake_nvcc(tmp_path, monkeypatch)
    root = tmp_path / "build"
    names = _build.kernel_names()
    assert "mlp_resnet_rollout" in names
    libs = _build.build(build_root=root)
    assert sorted(libs) == names
    calls = log.read_text().splitlines()
    assert len(calls) == len(names)
    for call in calls:
        assert call.startswith("-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 "
                               "-shared -Xcompiler -fPIC")
    lib = libs["mlp_resnet_rollout"]
    assert lib == _build.library_path("mlp_resnet_rollout", root)
    assert lib.parent.parent == root and lib.parent.name.startswith("mlp_resnet_rollout-")
    assert lib.is_file() and not list(lib.parent.glob("*.tmp"))
    assert "Used 40 registers" in (lib.parent / "build.log").read_text()
    # A finished build is reused: no second nvcc.
    assert _build.build(["mlp_resnet_rollout"], build_root=root) == {"mlp_resnet_rollout": lib}
    assert len(log.read_text().splitlines()) == len(names)


def test_build_directory_follows_the_source(tmp_path, monkeypatch):
    before = _build.library_path("mlp_resnet_rollout", tmp_path)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src = (_build.CSRC / "mlp_resnet_rollout.cu").read_text()
    (csrc / "mlp_resnet_rollout.cu").write_text(src + "\n// edited\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build.library_path("mlp_resnet_rollout", tmp_path) != before


def test_failed_build_raises_with_nvccs_stderr(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, fail=True)
    with pytest.raises(RuntimeError, match=r"(?s)exit 2.*expected a ';'"):
        _build.build(["mlp_resnet_rollout"], build_root=tmp_path / "build")
    assert not list((tmp_path / "build").rglob("*.so*"))


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
