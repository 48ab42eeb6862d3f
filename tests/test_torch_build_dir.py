"""Where the kernel library is built: ``kernels/_build.py::build_dir``.

``$CDMI_TORCH_BUILD_DIR`` wins; without it the package's own ``build/``
when it can be written, else ``~/.cache/cdmi_torch`` (a read-only
install). A build that cannot run still raises, wherever it would write.
"""

from pathlib import Path

import pytest

from cudadepthmapintegration_torch.kernels import _build


def test_override(monkeypatch, tmp_path):
    monkeypatch.setenv("CDMI_TORCH_BUILD_DIR", str(tmp_path / "kernels"))
    assert _build.build_dir() == tmp_path / "kernels"


def test_package_dir_when_writable(monkeypatch, tmp_path):
    monkeypatch.delenv("CDMI_TORCH_BUILD_DIR", raising=False)
    monkeypatch.setattr(_build, "PKG_BUILD_DIR", tmp_path / "pkg" / "build")
    (tmp_path / "pkg").mkdir()
    assert _build.build_dir() == tmp_path / "pkg" / "build"


@pytest.mark.parametrize("exists", [False, True])
def test_user_cache_when_read_only(monkeypatch, tmp_path, exists):
    monkeypatch.delenv("CDMI_TORCH_BUILD_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    pkg_build = tmp_path / "pkg" / "build"
    pkg_build.mkdir(parents=True) if exists else (tmp_path / "pkg").mkdir()
    monkeypatch.setattr(_build, "PKG_BUILD_DIR", pkg_build)
    probed = []

    def access(path, mode):
        probed.append(Path(path))
        return False

    monkeypatch.setattr(_build.os, "access", access)
    assert _build.build_dir() == tmp_path / "home" / ".cache" / "cdmi_torch"
    assert probed == [pkg_build if exists else pkg_build.parent]


def test_failed_build_in_the_override_dir_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setenv("CDMI_TORCH_BUILD_DIR", str(tmp_path / "kernels"))
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'ptxas fatal: out of registers' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    with pytest.raises(RuntimeError, match="out of registers"):
        _build.load_library()
    assert (tmp_path / "kernels").is_dir()
    assert not list((tmp_path / "kernels").iterdir())  # objects cleaned up, no library
