"""The port's knob registry (horovod_tpu_torch/common/knobs.py) and its
lint (horovod_tpu_torch/analysis/knobcheck.py): the reference's lint cases
run through both lints with the same results; the KNOB_SPECS / OWED /
NOT_OWED partition of the reference's registry; the live tree; and
HOROVOD_LOG_LEVEL, which the port did not read."""

import logging
import os
import textwrap

import pytest

from horovod_tpu.analysis import knobcheck as ref
from horovod_tpu.common.knobs import KNOB_SPECS as REF_SPECS
from horovod_tpu_torch.analysis import knobcheck as port
from horovod_tpu_torch.common.knobs import KNOB_SPECS, NOT_OWED, OWED

pytestmark = pytest.mark.lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_ROOT = os.path.join(REPO, "horovod_tpu_torch")


def _same(got, want):
    """The port's messages name its own package; otherwise identical."""
    assert [e.replace("horovod_tpu_torch", "horovod_tpu") for e in got] \
        == want


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_knobs.py) through both lints
# ---------------------------------------------------------------------------

_BAD_SPECS = {
    "not_upper": {"type": "bool", "default": "0", "help": "h"},
    "HOROVOD_TPU_NO_HELP": {"type": "int", "default": "1", "help": ""},
    "HOROVOD_TPU_BAD_TYPE": {"type": "enum", "default": "x", "help": "h"},
    "HOROVOD_TPU_NO_CHOICES": {"type": "choice", "default": "a",
                               "help": "h"},
}
_BAD_DEFAULTS = {
    "HOROVOD_TPU_BAD_CHOICE_DEFAULT": {
        "type": "choice", "default": "spiral", "choices": ("a", "b"),
        "help": "h"},
    "HOROVOD_TPU_BAD_INT": {"type": "int", "default": "many", "help": "h"},
    "HOROVOD_TPU_BAD_BOOL": {"type": "bool", "default": "si", "help": "h"},
    "HOROVOD_TPU_OK_DISPLAY": {"type": "int",
                               "default": "100 (10 when elastic)",
                               "help": "h"},
    "HOROVOD_TPU_OK_DERIVED": {"type": "int", "default": "derived",
                               "help": "h"},
}
_READ_SPECS = {
    "HOROVOD_TPU_USED": {"type": "bool", "default": "0", "help": "h"},
    "HOROVOD_TPU_DEAD": {"type": "bool", "default": "0", "help": "h"},
    "HOROVOD_TPU_EXPORTED": {"type": "int", "default": "1", "help": "h",
                             "export": True},
}
_READ_SITES = [("mod.py", 3, "HOROVOD_TPU_USED", "environ.get"),
               ("mod.py", 9, "HOROVOD_TPU_UNDECLARED", "environ.get")]
_CHOICE_SPECS = {"HOROVOD_TPU_MODE": {"type": "choice", "default": "a",
                                      "choices": ("a", "b"), "help": "h"}}
_CHOICE_SITES = [("mod.py", 5, "HOROVOD_TPU_MODE", "environ.get"),
                 ("mod.py", 9, "HOROVOD_TPU_MODE", "_get_choice")]


@pytest.mark.parametrize("check, args", [
    ("validate_specs", (_BAD_SPECS,)),
    ("validate_specs", (REF_SPECS,)),
    ("validate_defaults", (_BAD_DEFAULTS,)),
    ("validate_defaults", (REF_SPECS,)),
    ("validate_reads", (_READ_SPECS, _READ_SITES)),
    ("validate_choice_reads", (_CHOICE_SPECS, _CHOICE_SITES)),
], ids=["bad-specs", "reference-specs", "bad-defaults", "reference-defaults",
        "reads", "choice-reads"])
def test_validators_match_reference(check, args):
    want = getattr(ref, check)(*args)
    _same(getattr(port, check)(*args), want)
    if args[0] is not REF_SPECS:
        assert want  # the seeded violations are caught


def _pkg(tmp_path, body: str) -> str:
    pkg = tmp_path / "pkg"
    (pkg / "common").mkdir(parents=True)
    (pkg / "common" / "env.py").write_text(
        'HOROVOD_TPU_CONST_KNOB = "HOROVOD_TPU_CONST_KNOB"\n')
    (pkg / "mod.py").write_text(textwrap.dedent(body))
    return str(pkg)


@pytest.mark.parametrize("body", [
    """\
    import os
    from .common.env import HOROVOD_TPU_CONST_KNOB, _get_bool

    a = os.environ.get("HOROVOD_TPU_LIT_KNOB")
    b = os.environ["HOROVOD_TPU_SUB_KNOB"]
    c = os.getenv("HOROVOD_TPU_GETENV_KNOB", "1")
    d = _get_bool(HOROVOD_TPU_CONST_KNOB)
    os.environ["HOROVOD_TPU_WRITTEN"] = "1"   # store: not a read
    name = "dynamic"
    e = os.environ.get(name)                  # unresolvable: skip
    f = os.environ.get("PATH")                # non-HOROVOD: skip
    """,
    "def broken(:\n",
], ids=["reads", "unparseable"])
def test_scanner_matches_reference(tmp_path, body):
    pkg = _pkg(tmp_path, body)
    ea, eb = [], []
    a = ref.scan_env_reads(pkg, errors=ea)
    b = port.scan_env_reads(pkg, errors=eb)
    assert b == a and eb == ea


def test_live_port_tree_through_the_reference_lint():
    """The reference's rules, run over the port with the port's registry,
    agree with the port's lint (which adds only the partition check)."""
    sites = ref.scan_env_reads(PKG_ROOT)
    assert port.scan_env_reads(PKG_ROOT) == sites
    assert ref.validate_reads(KNOB_SPECS, sites) == []
    assert ref.validate_choice_reads(KNOB_SPECS, sites) == []
    assert ref.validate_defaults(KNOB_SPECS) == []
    assert ref.validate_specs(KNOB_SPECS) == []


# ---------------------------------------------------------------------------
# the partition: every reference knob declared, owed or not owed, once
# ---------------------------------------------------------------------------

def test_tables_are_pairwise_disjoint():
    assert not set(KNOB_SPECS) & set(OWED)
    assert not set(KNOB_SPECS) & set(NOT_OWED)
    assert not set(OWED) & set(NOT_OWED)


def test_tables_cover_the_reference_registry():
    port_only = set(KNOB_SPECS) - set(REF_SPECS)
    assert set(KNOB_SPECS) | set(OWED) | set(NOT_OWED) == \
        set(REF_SPECS) | port_only
    # every owed or not-owed knob is one the reference declares
    assert set(OWED) | set(NOT_OWED) <= set(REF_SPECS)


def test_owed_knobs_name_their_roadmap_item():
    assert set(OWED.values()) == {"A10", "A15"}
    for knob in ("HOROVOD_TPU_SINGLE_LAUNCH", "HOROVOD_TPU_META_CACHE",
                 "HOROVOD_TPU_META_CACHE_WARMUP",
                 "HOROVOD_TPU_OVERLAP_PIPELINE",
                 "HOROVOD_TPU_OVERLAP_STAGE_BYTES",
                 "HOROVOD_TPU_ZERO1_PREFETCH"):
        assert OWED[knob] == "A10", knob
    for knob in ("HOROVOD_AUTOTUNE", "HOROVOD_CYCLE_TIME",
                 "HOROVOD_AUTOTUNE_WARMUP_SAMPLES",
                 "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE",
                 "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES",
                 "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE",
                 "HOROVOD_TPU_CALIBRATE", "HOROVOD_TPU_TUNE_PERSIST",
                 "HOROVOD_TPU_TUNE_PERSIST_DIR"):
        assert OWED[knob] == "A15", knob


def test_not_owed_knobs_give_a_reason():
    assert {"HOROVOD_TPU_XLA_LHS", "HOROVOD_TPU_HEARTBEAT_TIMEOUT"} <= \
        set(NOT_OWED)
    for knob, reason in NOT_OWED.items():
        assert reason.strip(), knob


@pytest.mark.parametrize("case, specs, owed, not_owed, needle", [
    ("declared-and-owed", {"HOROVOD_TPU_A": {}}, {"HOROVOD_TPU_A": "A15"},
     {}, "in both KNOB_SPECS and OWED"),
    ("declared-and-not-owed", {"HOROVOD_TPU_A": {}}, {},
     {"HOROVOD_TPU_A": "r"}, "in both KNOB_SPECS and NOT_OWED"),
    ("owed-and-not-owed", {}, {"HOROVOD_TPU_A": "A10"},
     {"HOROVOD_TPU_A": "r"}, "in both OWED and NOT_OWED"),
    ("owed-to-nothing", {}, {"HOROVOD_TPU_A": "later"}, {},
     "names no ROADMAP item"),
    ("no-reason", {}, {}, {"HOROVOD_TPU_A": " "}, "missing reason"),
])
def test_partition_violations_are_flagged(case, specs, owed, not_owed,
                                          needle):
    errs = port.validate_partition(specs, owed, not_owed)
    assert len(errs) == 1 and needle in errs[0], errs


def test_written_but_unread_owed_knob_is_not_dead(tmp_path):
    """The launcher writes HOROVOD_AUTOTUNE for its workers and no module
    reads it: OWED, not a dead knob. Once read, it must move into
    KNOB_SPECS: an owed read is undeclared, with its item named."""
    specs = {"HOROVOD_TPU_USED": {"type": "bool", "default": "0",
                                  "help": "h"}}
    sites = [("mod.py", 3, "HOROVOD_TPU_USED", "environ.get")]
    assert port.validate_reads(specs, sites, {"HOROVOD_AUTOTUNE": "A15"}) \
        == []
    errs = port.validate_reads(
        specs, sites + [("mod.py", 7, "HOROVOD_AUTOTUNE", "_get_bool")],
        {"HOROVOD_AUTOTUNE": "A15"})
    assert len(errs) == 1 and "mod.py:7" in errs[0] and \
        "OWED to A15" in errs[0]


def test_live_tree_is_clean():
    errors, stats = port.run(PKG_ROOT)
    assert errors == [], "\n".join(errors)
    assert stats["distinct_read"] >= 80
    assert stats["declared"] == len(KNOB_SPECS)
    assert stats["owed"] == len(OWED) and stats["not_owed"] == len(NOT_OWED)


# ---------------------------------------------------------------------------
# HOROVOD_LOG_LEVEL
# ---------------------------------------------------------------------------

@pytest.fixture
def restore_loggers():
    saved = {}
    for name in ("horovod_tpu", "horovod_tpu_torch"):
        lg = logging.getLogger(name)
        saved[name] = (lg.level, list(lg.handlers))
    yield
    for name, (level, handlers) in saved.items():
        lg = logging.getLogger(name)
        lg.setLevel(level)
        lg.handlers[:] = handlers


def test_log_level_debug_applies_at_init(monkeypatch, restore_loggers):
    """The port honours HOROVOD_LOG_LEVEL at hvd.init(), onto its own
    logger, as the reference's init does onto ``horovod_tpu``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu.core.state import _apply_log_level as ref_apply
    monkeypatch.setenv("HOROVOD_LOG_LEVEL", "debug")
    ref_apply()
    assert logging.getLogger("horovod_tpu").level == logging.DEBUG
    hvd.shutdown()
    logging.getLogger("horovod_tpu_torch").setLevel(logging.NOTSET)
    hvd.init(device="cpu")
    try:
        assert logging.getLogger("horovod_tpu_torch").level == logging.DEBUG
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("value, level", [
    ("trace", logging.DEBUG), ("info", logging.INFO),
    ("WARNING", logging.WARNING), ("error", logging.ERROR),
    ("fatal", logging.CRITICAL)])
def test_log_level_mapping_matches_reference(monkeypatch, restore_loggers,
                                             value, level):
    from horovod_tpu.core.state import _apply_log_level as ref_apply
    from horovod_tpu_torch.core.state import _apply_log_level
    monkeypatch.setenv("HOROVOD_LOG_LEVEL", value)
    ref_apply()
    _apply_log_level()
    assert logging.getLogger("horovod_tpu").level == level
    assert logging.getLogger("horovod_tpu_torch").level == level


def test_unknown_log_level_changes_nothing(monkeypatch, restore_loggers):
    from horovod_tpu_torch.core.state import _apply_log_level
    lg = logging.getLogger("horovod_tpu_torch")
    lg.setLevel(logging.ERROR)
    monkeypatch.setenv("HOROVOD_LOG_LEVEL", "chatty")
    _apply_log_level()
    assert lg.level == logging.ERROR
