"""Unified framework CLI: ``python -m kanodes <command> [args...]``.

The reference is driven by editing per-experiment script constants
(`LV_driver_KANODE.jl:23-25,110-141`) or per-script env vars
(`StrainLimiting_KAN_PINN.py:2004-2096`); there is no single entry
point. This framework exposes every driver behind one command surface.
Each command forwards argv unchanged to the module's own CLI, so
``python -m kanodes lv --iters=20000`` is exactly
``python -m kanodes.experiments.lv --iters=20000`` — the umbrella
adds discoverability (``--help`` lists the whole surface), not a new
argument scheme.
"""

from __future__ import annotations

import runpy
import sys

# command -> (module run as __main__, one-line help)
MODULE_COMMANDS: dict[str, tuple[str, str]] = {
    "lv": ("kanodes.experiments.lv",
           "LV KAN-ODE training driver (KANODE_LV_* env + --key=value "
           "overrides, --checkpoint, --restart)"),
    "lv-symbolic": ("kanodes.experiments.lv_symbolic",
                    "LV train -> prune -> symbolic-regression pipeline"),
    "surrogate": ("kanodes.experiments.pde_surrogate",
                  "PDE surrogate training: burgers | schrodinger | "
                  "allen_cahn"),
    "source": ("kanodes.experiments.pde_source",
               "gray-box hidden-source recovery: fisher_kpp | "
               "allen_cahn (1-D/2-D)"),
    "sweep": ("kanodes.experiments.sweep",
              "param-efficiency trend sweep / ensemble seed training"),
    "pinn": ("kanodes.pinn.train",
             "strain-limiting V-notch KAN-PINN (--julia preset, "
             "--checkpoint[=dir], --resume, --out=diag.json)"),
}

# command -> (import path, attr, one-line help); called as main(rest)
FUNC_COMMANDS: dict[str, tuple[str, str, str]] = {
    "claims": ("kanodes.diag.claims", "main",
               "re-derive every README headline number from its "
               "committed artifact (--deep reloads the param files; "
               "exit 0 verified / 1 mismatch)"),
    "gates": ("kanodes.diag.gates", "main",
              "PINN acceptance gates: <diagnostics.json> | "
              "--checkpoint <dir> (exit 0 PASS / 1 FAIL)"),
    "export": ("kanodes.deploy.__main__", "main",
               "export a checkpoint / params .npy as a serving "
               "artifact (StableHLO)"),
}


def _usage() -> str:
    lines = ["usage: python -m kanodes <command> [args...]", "",
             "commands:"]
    for name, (_, help_line) in sorted(MODULE_COMMANDS.items()):
        lines.append(f"  {name:<12} {help_line}")
    for name, (_, _, help_line) in sorted(FUNC_COMMANDS.items()):
        lines.append(f"  {name:<12} {help_line}")
    lines += ["",
              "Each command accepts the same args as its module CLI "
              "(python -m kanodes.<module>); see API.md."]
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(_usage())
        return 2
    cmd, rest = argv[0], argv[1:]
    if cmd in ("-h", "--help", "help"):
        print(_usage())
        return 0
    if cmd in FUNC_COMMANDS:
        path, attr, _ = FUNC_COMMANDS[cmd]
        mod = __import__(path, fromlist=[attr])
        return int(getattr(mod, attr)(rest))
    if cmd in MODULE_COMMANDS:
        module = MODULE_COMMANDS[cmd][0]
        # the module mains read sys.argv[1:]; alter_sys restores it after
        sys.argv = [module] + rest
        runpy.run_module(module, run_name="__main__", alter_sys=True)
        return 0
    print(f"unknown command: {cmd!r}\n", file=sys.stderr)
    print(_usage(), file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
