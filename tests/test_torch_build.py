"""The kernel build's lock (``repro_torch.kernels.build``): two threads
that reach an unbuilt kernel together build it once and load it once,
and each build writes to a temporary file of its own. No ``nvcc`` runs
here: ``build_all`` and ``ctypes.CDLL`` are replaced by recorders."""
import threading
import time

import pytest

from repro_torch.kernels import build


@pytest.fixture
def stale_library(tmp_path, monkeypatch):
    lib = tmp_path / "libcd_solve-stale.so"
    calls = {"build": [], "load": []}

    def fake_build_all():
        calls["build"].append(threading.get_ident())
        time.sleep(0.2)                  # both threads arrive meanwhile
        lib.write_bytes(b"")
        return 0.2

    monkeypatch.setattr(build, "library_path", lambda name: lib)
    monkeypatch.setattr(build, "build_all", fake_build_all)
    monkeypatch.setattr(build.ctypes, "CDLL",
                        lambda path: calls["load"].append(path) or path)
    monkeypatch.setattr(build, "_LIBS", {})
    return lib, calls


def test_two_threads_build_and_load_a_stale_library_once(stale_library):
    lib, calls = stale_library
    start = threading.Barrier(2)
    got, errors = [], []

    def worker():
        try:
            start.wait(timeout=10)
            got.append(build.load("cd_solve"))
        except Exception as e:                    # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    assert not errors
    assert len(calls["build"]) == 1 and calls["load"] == [str(lib)]
    assert got == [str(lib), str(lib)]
    assert build.load("cd_solve") == str(lib) and len(calls["load"]) == 1


def test_tmp_names_differ_by_thread_and_process():
    names = []
    both = threading.Barrier(2)          # alive together: distinct idents

    def name():
        names.append(build._tmp_path("gram"))
        both.wait(timeout=10)

    threads = [threading.Thread(target=name) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    names.append(build._tmp_path("gram"))
    assert len(set(names)) == 3
    assert all(n.parent == build.BUILD_DIR and n.suffix == ".tmp"
               for n in names)
