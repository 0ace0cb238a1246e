"""``chip_smoke.py`` dry run: every phase of the one-card smoke test on
the CPU at tiny sizes (the GPU kernel under the Pallas interpreter), so
the script's control flow and checks stay runnable between runs on the
card."""

import importlib.util
import json
import os

import pytest

_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "chip_smoke.py")


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_dry_run(capsys):
    import jax

    smoke = _load()
    smoke._REHEARSE = True
    before = jax.config.jax_compilation_cache_dir
    try:
        smoke.main(["--n", "60000", "--q", "600", "--truth-q", "256",
                    "--reps", "2"])
    finally:  # the script points the compile cache into the checkout
        jax.config.update("jax_compilation_cache_dir", before)
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert last == {"ok": True, "device": {
        "platform": "cpu", "kind": "cpu", "count": 8}}
    phases = {json.loads(x)["phase"] for x in lines if x.startswith("{")
              and "phase" in x}
    assert {"build", "serve_full", "serve_pruned_all_blocks", "kernel_ref",
            "routes", "mutable", "out_of_core", "done"} <= phases


def test_chip_smoke_refuses_the_cpu():
    smoke = _load()
    with pytest.raises(SystemExit) as exc:
        smoke.main([])
    assert "needs a GPU" in str(exc.value)
