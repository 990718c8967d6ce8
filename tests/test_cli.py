"""Unified CLI dispatcher (`python -m kanodes <command>`)."""

import importlib
import json
import os
import pathlib
import subprocess
import sys

import pytest

from kanodes import __main__ as cli


def test_help_lists_every_command(capsys):
    assert cli.main(["--help"]) == 0
    out = capsys.readouterr().out
    for name in list(cli.MODULE_COMMANDS) + list(cli.FUNC_COMMANDS):
        assert name in out


def test_no_args_prints_usage_and_fails(capsys):
    assert cli.main([]) == 2
    assert "usage:" in capsys.readouterr().out


def test_unknown_command(capsys):
    assert cli.main(["frobnicate"]) == 2
    assert "unknown command" in capsys.readouterr().err


def test_module_command_dispatch(monkeypatch):
    calls = {}

    def fake_run_module(module, run_name=None, alter_sys=False):
        calls["module"] = module
        calls["run_name"] = run_name
        calls["argv"] = list(cli.sys.argv)

    monkeypatch.setattr(cli.runpy, "run_module", fake_run_module)
    assert cli.main(["lv", "--iters=100", "--restart"]) == 0
    assert calls["module"] == "kanodes.experiments.lv"
    assert calls["run_name"] == "__main__"
    assert calls["argv"][1:] == ["--iters=100", "--restart"]


@pytest.mark.parametrize("name,module", sorted(cli.MODULE_COMMANDS.items(),
                                               key=lambda kv: kv[0]))
def test_module_commands_resolve(name, module):
    """Every advertised module target imports and has a __main__ block."""
    import importlib
    mod = importlib.import_module(module[0])
    src = open(mod.__file__).read()
    assert '__name__ == "__main__"' in src, module[0]


def test_gates_command_end_to_end(tmp_path, capsys):
    diag = {"tip_near_far_ratio": 1.5, "best_val": 1.0,
            "symmetry_mean_abs": 0.01, "pde_residual_mean_abs": 1.0,
            "nonfinite_grid_points": 0}
    p = tmp_path / "diag.json"
    p.write_text(json.dumps(diag))
    assert cli.main(["gates", str(p)]) == 0
    assert "PASS" in capsys.readouterr().out
    diag["best_val"] = 1e9
    p.write_text(json.dumps(diag))
    assert cli.main(["gates", str(p)]) == 1


def test_export_command_resolves():
    from kanodes.deploy.__main__ import main as export_main
    path, attr, _ = cli.FUNC_COMMANDS["export"]
    mod = __import__(path, fromlist=[attr])
    assert getattr(mod, attr) is export_main


# the package's former name: a directory next to `kanodes` that aliases it
_ROOT = pathlib.Path(__file__).resolve().parents[1]
FORMER_NAME = next(p.name for p in _ROOT.iterdir()
                   if p.name.startswith("kanodes_")
                   and (p / "__init__.py").is_file())


@pytest.mark.parametrize("sub", ["experiments.lv", "models.kdense",
                                 "ops.rk_fused", "diag.claims"])
def test_former_name_aliases_the_same_modules(sub):
    """`import <former>.x` returns the very module `kanodes.x` is, so
    classes and registries exist once."""
    old = importlib.import_module(f"{FORMER_NAME}.{sub}")
    assert old is importlib.import_module(f"kanodes.{sub}")


def test_former_name_runs_the_cli():
    out = subprocess.run([sys.executable, "-m", FORMER_NAME, "--help"],
                         capture_output=True, text=True, cwd=_ROOT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "usage: python -m kanodes" in out.stdout
