"""The port's lint verb (sparknet_tpu_torch/analysis/, a copy of the JAX
package's stdlib-only analyzer) against the JAX package's: the same
findings and exit codes over the fixture corpus, the port linting clean
under --strict against its own baseline, and --write-event-schema
reproducing the committed registry."""

import contextlib
import io
import json
import os

import pytest

from sparknet_tpu import cli as jcli
from sparknet_tpu_torch import cli
from sparknet_tpu_torch.analysis import ALL_CODES, all_rules
from sparknet_tpu_torch.analysis import metrics_rules
from sparknet_tpu_torch.analysis.baseline import Baseline
from sparknet_tpu_torch.analysis.cli import DEFAULT_BASELINE

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIXTURES = os.path.join(HERE, "fixtures", "lint")


def _lint(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["lint"] + argv)
    return rc, buf.getvalue()


def _findings(main, paths, *extra):
    rc, out = _lint(main, paths + ["--root", REPO, "--json", *extra])
    rows = json.loads(out)["findings"]
    return rc, sorted((f["code"], f["path"], f["line"], f["severity"])
                      for f in rows)


def test_rule_table_is_the_jax_packages():
    from sparknet_tpu.analysis import ALL_CODES as JCODES
    from sparknet_tpu.analysis import all_rules as jall_rules
    all_rules()
    jall_rules()
    assert {c: (n, s) for c, (n, s, _) in ALL_CODES.items()} == \
        {c: (n, s) for c, (n, s, _) in JCODES.items()}
    assert {"SPK001", "SPK101", "SPK105", "SPK201", "SPK207", "SPK301",
            "SPK304", "SPK401", "SPK402"} <= set(ALL_CODES) | {"SPK001"}


def test_fixture_corpus_gives_the_jax_verbs_findings():
    fixtures = sorted(os.path.join(FIXTURES, f)
                      for f in os.listdir(FIXTURES) if f.endswith(".py"))
    assert len(fixtures) == 10
    port = _findings(cli.main, fixtures)
    ref = _findings(jcli.main, fixtures)
    assert port == ref
    assert len({code for code, _, _, _ in port[1]}) >= 10
    for f in fixtures:
        for extra in ([], ["--strict"]):
            assert _findings(cli.main, [f], *extra) == \
                _findings(jcli.main, [f], *extra), (f, extra)


def test_port_lints_clean_under_strict_with_a_justified_baseline():
    rc, out = _lint(cli.main, ["--strict"])
    assert rc == 0, out
    assert "0 findings" in out
    path = os.path.join(REPO, DEFAULT_BASELINE)
    assert os.path.basename(path) == ".sparknet-torch-lint-baseline.json"
    baseline = Baseline.load(path)
    assert not baseline.unjustified()
    for fp, entry in baseline.entries.items():
        assert entry["path"].startswith("sparknet_tpu_torch/"), fp


def test_write_event_schema_reproduces_the_committed_registry(
        tmp_path, monkeypatch):
    committed = metrics_rules.schema_path()
    assert committed == os.path.join(REPO, "sparknet_tpu_torch", "obs",
                                     "event_schema.py")
    out = str(tmp_path / "event_schema.py")
    monkeypatch.setattr(metrics_rules, "schema_path", lambda: out)
    rc, text = _lint(cli.main, ["--write-event-schema"])
    assert rc == 0 and out in text
    with open(out) as f, open(committed) as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("argv,rc", [(["--list-rules"], 0),
                                     (["/no/such/path.py"], 2),
                                     (["--select", "SPK999", FIXTURES], 2)])
def test_usage_paths_exit_as_the_jax_verb(argv, rc):
    assert _lint(cli.main, argv)[0] == _lint(jcli.main, argv)[0] == rc
