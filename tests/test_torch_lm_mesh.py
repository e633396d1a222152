"""The ``lm`` verb's mesh branches, the port's against the JAX verb's, in
process on the CPU.

Each branch (``--dp 2``, ``--fsdp on --dp 2``, ``--tp 2``, ``--sp 2``,
``--ep 2 --moe-experts 4``, ``--pipeline-stages 2 --microbatches 2``)
resumes both verbs from one snapshot the JAX verb wrote at step 0 and
takes 3 steps of a tiny LM (vocab 32, S 32, batch 4, d 16, 2 layers, 2
heads); the printed losses agree within 1e-5 relative, and the MoE
branch prints the routing line. The JAX verb runs on the virtual
8-device CPU mesh, so its ``--tp 2`` mesh is data 4 x model 2 and the
port's data 1 x model 2 (the same numbers: tensor parallelism computes
the single-device step). The combinations the JAX verb refuses exit with
its messages, and every JAX flag parses with its default.
``--fsdp`` and ``--tp`` write SPARKNET_FSDP and SPARKNET_TP into the
process (ROADMAP C13), so every call pins both.
"""

import re

import numpy as np
import pytest

from sparknet_tpu import cli as jcli
from sparknet_tpu_torch import cli as tcli

TINY = ["lm", "--vocab", "32", "--seq-len", "32", "--batch", "4",
        "--d-model", "16", "--layers", "2", "--heads", "2", "--display",
        "1", "--no-flash", "--seed", "4"]
STEPS = 3


def _losses(out):
    return [float(m) for m in re.findall(r"Iteration \d+, loss = (\S+),",
                                         out)]


def _call(main, argv, monkeypatch, capsys):
    monkeypatch.setenv("SPARKNET_FSDP", "off")
    monkeypatch.setenv("SPARKNET_TP", "0")
    assert main(argv) in (0, None)
    return capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--dp", "2"], ["--fsdp", "on", "--dp", "2"], ["--tp", "2"],
    ["--sp", "2"], ["--ep", "2", "--moe-experts", "4"],
    ["--pipeline-stages", "2", "--microbatches", "2"]],
    ids=["dp", "fsdp", "tp", "sp", "ep", "pipeline"])
def test_lm_verb_mesh_branch_matches_the_jax_verb(flags, tmp_path,
                                                  monkeypatch, capsys):
    prefix = str(tmp_path / "start")
    # the start snapshot of the same net: the MoE LM for --ep, the
    # pipeline's .lm.npz for --pipeline-stages
    start = ["--moe-experts", "4"] if "--moe-experts" in flags else \
        flags if "--pipeline-stages" in flags else []
    _call(jcli.main, TINY + start + ["--steps", "0", "--snapshot-prefix",
                                     prefix], monkeypatch, capsys)
    state = f"{prefix}_iter_0.lm.npz" if "--pipeline-stages" in flags \
        else f"{prefix}_iter_0.solverstate"
    args = TINY + flags + ["--steps", str(STEPS), "--resume", state]
    port = _call(tcli.main, args + ["--device", "cpu"], monkeypatch, capsys)
    ref = _call(jcli.main, args, monkeypatch, capsys)
    assert len(_losses(port)) == len(_losses(ref)) == STEPS
    np.testing.assert_allclose(_losses(port), _losses(ref), rtol=1e-5)
    assert "done: 3 steps" in port and "Kernel launches" in port
    if "--moe-experts" in flags:
        util = re.findall(r"iter \d+: expert util \[(.*)\] overflow (\S+)",
                          port)
        want = re.findall(r"iter \d+: expert util \[(.*)\] overflow (\S+)",
                          ref)
        assert len(util) == len(want) == STEPS
        for (u, o), (wu, wo) in zip(util, want):
            np.testing.assert_allclose(
                [float(x) for x in u.split(",")] + [float(o)],
                [float(x) for x in wu.split(",")] + [float(wo)], atol=2e-3)


@pytest.mark.parametrize("flags", [
    ["--fsdp", "on", "--tp", "2"], ["--tp", "2", "--sp", "2"],
    ["--fsdp", "on", "--pipeline-stages", "2"],
    ["--dp", "2", "--pipeline-stages", "2"], ["--ep", "2"],
    ["--pipeline-stages", "2", "--moe-experts", "4"],
    ["--snapshot-every", "2"]])
def test_lm_verb_refuses_what_the_jax_verb_refuses(flags, monkeypatch):
    msgs = []
    for main in (jcli.main, tcli.main):
        monkeypatch.setenv("SPARKNET_FSDP", "off")
        monkeypatch.setenv("SPARKNET_TP", "0")
        with pytest.raises(SystemExit) as e:
            main(TINY + flags + ["--steps", "1"] + (
                ["--device", "cpu"] if main is tcli.main else []))
        msgs.append(str(e.value.code))
    assert msgs[1] == msgs[0] and len(msgs[0]) > 10


def _lm_flags(parser):
    import argparse
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {tuple(sorted(a.option_strings)): (a.dest, a.default)
            for a in sub.choices["lm"]._actions if a.option_strings}


def test_lm_verb_takes_every_jax_flag_with_its_default():
    """Every flag of the JAX `lm` verb parses in the port's with the same
    destination and default (the port adds --device), and none is a
    refusal any more: the mesh flags and --microbatches run."""
    import argparse
    from unittest import mock
    box = {}

    class Parsed(Exception):
        pass

    def grab(self, args=None, namespace=None):
        box["parser"] = self
        raise Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(Parsed):
            jcli.main(["lm"])
    ref = _lm_flags(box["parser"])
    port = _lm_flags(tcli.parser())
    assert set(port) - set(ref) == {("--device",)}
    for key, spec in ref.items():
        assert port[key] == spec, key
    kinds = {type(a).__name__ for a in next(
        a for a in tcli.parser()._actions
        if isinstance(a, argparse._SubParsersAction)).choices["lm"]._actions}
    assert "_NotPorted" not in kinds      # --scan on is ported too
    assert not hasattr(tcli, "_LM_NOT_PORTED")
