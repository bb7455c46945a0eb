"""The static checkers over the port (``geomx_tpu_torch.analysis``).

The port's ``analysis/`` is the JAX package's, copied with exactly two
edits: every ``geomx_tpu`` token becomes ``geomx_tpu_torch`` and
``DEFAULT_BASELINE`` names the port's own ``analysis-baseline-torch.toml``.

- each copied checker equals its original under those two edits;
- the fixture trees of ``tests/test_analysis.py``, written once under
  ``geomx_tpu/`` for the JAX checkers and once under ``geomx_tpu_torch/``
  for the port's, give the same findings once the path is rewritten;
  the baseline mechanics (placeholder reasons, missing fields, glob
  keys, the skeleton) behave the same in both;
- over the live trees, the findings the port's checkers raise in each
  module the port copied verbatim equal those the JAX checkers raise in
  its original, after the path rewrite;
- the live port tree is clean modulo ``analysis-baseline-torch.toml``
  with no stale entry, and that baseline is the JAX one with its keys
  rewritten and its reasons kept;
- the checker catalogs are equal.
"""

import pathlib
import re
import textwrap

import pytest

from geomx_tpu import analysis as J
from geomx_tpu.analysis import baseline as j_baseline
from geomx_tpu_torch import analysis as P
from geomx_tpu_torch.analysis import baseline as p_baseline
from tests import test_analysis as TA

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = ("__init__", "__main__", "baseline", "core", "config_drift",
         "decode_bounds", "doc_drift", "lock_discipline",
         "reactor_blocking", "wire_protocol")


def _rewrite(text: str) -> str:
    return re.sub(r"geomx_tpu\b", "geomx_tpu_torch", text)


@pytest.mark.parametrize("name", FILES)
def test_copied_checker_equals_its_original_under_the_two_edits(name):
    orig = (ROOT / "geomx_tpu" / "analysis" / f"{name}.py").read_text()
    port = (ROOT / "geomx_tpu_torch" / "analysis" / f"{name}.py").read_text()
    want = _rewrite(orig)
    if name == "baseline":
        line = 'DEFAULT_BASELINE = "analysis-baseline.toml"'
        assert want.count(line) == 1
        want = want.replace(
            line, 'DEFAULT_BASELINE = "analysis-baseline-torch.toml"')
    assert port == want


def _findings(pkg, tmp_path, files, docs, checker):
    """One checker of ``pkg`` (``J`` or ``P``) over the fixture tree,
    written under that package's own name; keys in JAX's spelling."""
    port = pkg is P
    root = tmp_path / ("port" if port else "jax")
    for rel, text in files.items():
        p = root / (_rewrite(rel) if port else rel)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(_rewrite(text) if port else text))
    for rel, text in (docs or {}).items():
        p = root / "docs" / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    found = pkg.CHECKERS[checker]().run(pkg.Project(root))
    out = []
    for f in found:
        key, path = f.key, f.path
        if port:
            key = key.replace("geomx_tpu_torch/", "geomx_tpu/")
            path = path.replace("geomx_tpu_torch/", "geomx_tpu/")
        out.append((f.checker, path, f.line, key, f.message.replace(
            "geomx_tpu_torch", "geomx_tpu")))
    return sorted(out)


_INTERPROC = {"geomx_tpu/mod.py": '''
    import threading

    class A:
        def __init__(self):
            self._a_mu = threading.Lock()
            self._b_mu = threading.Lock()

        def outer(self):
            with self._a_mu:
                self.inner()

        def inner(self):
            with self._b_mu:
                pass

        def reversed_outer(self):
            with self._b_mu:
                with self._a_mu:
                    pass
    '''}
_WAIT_DEFAULT = {"geomx_tpu/mod.py": '''
    class H:
        def __init__(self, reactor):
            self.chan = reactor.channel(self._on)

        def _on(self, msg):
            ts = self.app.send_cmd(msg.sender, 1, wait=False)  # ok
            self.customer.wait(ts)   # VIOLATION: 120 s default timeout
    '''}
# tests/test_analysis.py's fixtures: (files, docs, checker, a key the
# JAX test asserts, so that an empty run cannot pass)
FIXTURES = {
    "lock": (TA.LOCK_FIXTURE, None, "lock-discipline",
             "geomx_tpu/mod.py::Server.bad::_apply_locked"),
    "lock_interprocedural": (_INTERPROC, None, "lock-discipline", None),
    "reactor": (TA.REACTOR_FIXTURE, None, "reactor-blocking",
                "geomx_tpu/mod.py::Tick._sweep::queue-get:get"),
    "reactor_wait_default": (_WAIT_DEFAULT, None, "reactor-blocking",
                             "geomx_tpu/mod.py::H._on::wait-default:wait"),
    "wire": (TA.WIRE_FIXTURE, None, "wire-protocol",
             "geomx_tpu/transport/message.py::Control::dup:7"),
    "config": (TA.CONFIG_FIXTURE, TA.CONFIG_DOCS, "config-drift",
               "docs/env-vars.md::doc::stale:GEOMX_GONE"),
    "metrics": (TA.METRICS_FIXTURE, TA.METRICS_DOCS, "metrics-doc",
                "docs/metrics.md::row::stale_metric"),
}


@pytest.mark.parametrize("case", sorted(FIXTURES))
def test_fixture_findings_equal_the_jax_checkers(case, tmp_path):
    files, docs, checker, must = FIXTURES[case]
    jax_f = _findings(J, tmp_path, files, docs, checker)
    port_f = _findings(P, tmp_path, files, docs, checker)
    assert jax_f, case
    assert port_f == jax_f
    keys = {f[3] for f in port_f}
    if must is not None:
        assert must in keys, keys
    else:
        assert any(k.startswith("lock-order-cycle::") for k in keys), keys


_GLOB_BASELINE = ('[[suppress]]\nchecker = "lock-discipline"\n'
                  'key = "geomx_tpu/mod.py::Server.bad::*"\n'
                  'reason = "fixture test exercising glob suppression '
                  'keys"\n')


@pytest.mark.parametrize("text", [
    '[[suppress]]\nchecker = "x"\nkey = "a::b::c"\nreason = "TODO"\n',
    '[[suppress]]\nchecker = "x"\nkey = "a::b::c"\nreason = "short"\n',
    '[[suppress]]\nchecker = "x"\n'
    'reason = "a perfectly fine justification"\n'],
    ids=["placeholder", "short", "no-key"])
def test_baseline_rejects_what_the_jax_baseline_rejects(text):
    with pytest.raises(j_baseline.BaselineError):
        j_baseline.parse(text)
    with pytest.raises(p_baseline.BaselineError):
        p_baseline.parse(text)


def test_baseline_globs_and_skeleton_match_the_jax_baseline(tmp_path):
    split = {}
    for pkg, bmod in ((J, j_baseline), (P, p_baseline)):
        port = pkg is P
        files = ({_rewrite(k): v for k, v in TA.LOCK_FIXTURE.items()}
                 if port else TA.LOCK_FIXTURE)
        root = tmp_path / ("port" if port else "jax")
        for rel, text in files.items():
            p = root / rel
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(textwrap.dedent(text))
        findings = pkg.CHECKERS["lock-discipline"]().run(pkg.Project(root))
        bl = pkg.Baseline(bmod.parse(
            _rewrite(_GLOB_BASELINE) if port else _GLOB_BASELINE))
        fresh, eaten = bl.filter(findings)
        assert not bl.unused()
        with pytest.raises(bmod.BaselineError):
            bmod.parse(bmod.skeleton(findings))
        split[port] = tuple(sorted(f.key.replace("geomx_tpu_torch/",
                                                 "geomx_tpu/") for f in fs)
                            for fs in (fresh, eaten))
    assert split[True] == split[False]
    assert any("::Server.bad::" in k for k in split[True][1])


def _copied_rels() -> set:
    """Modules of the port equal to their JAX original after the
    prefix rewrite (the copies), by their port path."""
    out = set()
    for p in (ROOT / "geomx_tpu_torch").rglob("*.py"):
        rel = p.relative_to(ROOT).as_posix()
        orig = ROOT / ("geomx_tpu/" + rel.split("/", 1)[1])
        if orig.exists() and _rewrite(orig.read_text()) == p.read_text():
            out.add(rel)
    return out


@pytest.fixture(scope="module")
def live():
    """Every checker's findings over both live trees (run once)."""
    jp = J.Project(ROOT)
    pp = P.Project(ROOT)
    return {name: (J.CHECKERS[name]().run(jp), P.CHECKERS[name]().run(pp))
            for name in J.CHECKERS}


@pytest.mark.parametrize("checker", sorted(J.CHECKERS))
def test_copied_modules_find_what_their_originals_find(checker, live):
    copied = _copied_rels()
    assert "geomx_tpu_torch/kvstore/replication.py" in copied
    jax_f, port_f = live[checker]
    port_keys = sorted(f.key for f in port_f if f.path in copied)
    jax_keys = sorted(_rewrite(f.key) for f in jax_f
                      if _rewrite(f.path) in copied)
    assert port_keys == jax_keys


def test_live_port_tree_clean_modulo_its_baseline(live):
    bl = P.Baseline.load(ROOT / p_baseline.DEFAULT_BASELINE)
    findings = [f for _, port_f in live.values() for f in port_f]
    fresh, eaten = bl.filter(findings)
    assert not fresh, "unsuppressed findings:\n" + "\n".join(
        f.render() for f in fresh)
    assert not bl.unused(), [(s.checker, s.key) for s in bl.unused()]
    assert len(eaten) == 11


def test_port_baseline_is_the_jax_baseline_rewritten():
    port = p_baseline.parse(
        (ROOT / "analysis-baseline-torch.toml").read_text())
    jax = j_baseline.parse((ROOT / "analysis-baseline.toml").read_text())
    assert p_baseline.DEFAULT_BASELINE == "analysis-baseline-torch.toml"
    assert [(s.checker, s.key, s.reason) for s in port] == [
        (s.checker, _rewrite(s.key), s.reason) for s in jax]


def test_checker_catalogs_are_equal():
    assert list(P.CHECKERS) == list(J.CHECKERS)
    for name, cls in P.CHECKERS.items():
        assert cls.name == name
        assert cls.description == J.CHECKERS[name].description
