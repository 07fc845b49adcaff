"""The build helpers the measuring and fault scripts share, on the CPU.

``kbuild.edited_copies`` writes edited copies of a CUDA source beside the
headers they include and sends later builds to the copies' directory;
``kbuild.use_copy`` points a kernel module's source and cached loader at
one copy.  Neither compiles anything here: the loader is a stand-in.
"""
import functools
import types

import pytest

from repro_torch.kernels import build as kbuild

pytestmark = pytest.mark.tier1


def _source(tmp_path):
    src = tmp_path / "kern.cu"
    src.write_text('#include "hopper.cuh"\nint f() { return 1; }\n')
    return src


def test_edited_copies_writes_one_edited_copy_a_name(tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(kbuild, "BUILD_DIR", kbuild.BUILD_DIR)
    src, into = _source(tmp_path), tmp_path / "copies"
    into.mkdir()
    paths = kbuild.edited_copies(src, {
        "sound": [],
        "no return, two": [("return 1;", "return 2;")],
        "renamed": [("int f()", "int g()"), ("return 1;", "return 3;")],
    }, into)
    assert list(paths) == ["sound", "no return, two", "renamed"]
    assert paths["no return, two"].name == "kern_no_return_two.cu"
    assert paths["sound"].read_text() == src.read_text()
    assert "return 2;" in paths["no return, two"].read_text()
    assert "int g() { return 3; }" in paths["renamed"].read_text()
    assert (into / "hopper.cuh").read_text() == \
        (kbuild.CSRC / "hopper.cuh").read_text()
    assert kbuild.BUILD_DIR == into / "lib"


@pytest.mark.parametrize("old", ["return 9;", "int"])
def test_edited_copies_refuses_an_anchor_not_found_once(tmp_path,
                                                        monkeypatch, old):
    monkeypatch.setattr(kbuild, "BUILD_DIR", kbuild.BUILD_DIR)
    src = _source(tmp_path)
    src.write_text(src.read_text() + "int h() { return 4; }\n")
    with pytest.raises(ValueError, match="no longer has one"):
        kbuild.edited_copies(src, {"cut": [(old, "")]}, tmp_path)


def test_use_copy_rebinds_source_and_cached_loader(tmp_path):
    mod = types.SimpleNamespace(SRC=tmp_path / "orig.cu")

    @functools.cache
    def _library():
        return ("library of", mod.SRC)

    mod._library = _library
    first, second = tmp_path / "a.cu", tmp_path / "b.cu"
    assert kbuild.use_copy(mod, first) == ("library of", first)
    assert mod.SRC == first and mod._library() == ("library of", first)
    # a second copy rebinds through the same uncached loader
    assert kbuild.use_copy(mod, second) == ("library of", second)
    assert mod._library() == ("library of", second)
    assert mod._library.__wrapped__ is _library.__wrapped__
