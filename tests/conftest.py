import os
import sys

# Tests run on the CPU backend with 8 virtual devices (mesh tests need
# several); device-only checks carry the ``gpu`` marker and run in
# chip_smoke.py on the card.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )

import re

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The reference's own models, word lists and foma sources (its
# ``testdata/`` directory), named by DATOK_REFERENCE_TESTDATA.  Tests
# whose expectations belong to those files skip without it.
REF = os.environ.get("DATOK_REFERENCE_TESTDATA", "")


def require_reference(*names: str) -> str:
    """Skip the calling test unless the reference test data (and each
    named file in it) is present; returns its directory."""
    missing = [n for n in ("",) + names if not os.path.exists(os.path.join(REF, n))]
    if not REF or missing:
        pytest.skip(
            "reference test data not present (the published models and "
            f"word lists are not part of this repository): {REF}"
        )
    return REF


@pytest.fixture(scope="session")
def ref_testdata():
    return require_reference()


def _synth(profile: str, kind: str = "matok"):
    from datok import load_tokenizer_file
    from datok.fsa.synth import model_path

    return load_tokenizer_file(model_path(profile, kind))


@pytest.fixture(scope="session")
def mat_de():
    """DE-size generated grammar (18.6K states × 171 symbols)."""
    return _synth("synth_de18k")


@pytest.fixture(scope="session")
def mat_en():
    """Second generated grammar at the EN model's size."""
    return _synth("synth_en15k")


@pytest.fixture(scope="session")
def dat_de():
    """Double-array build of the DE-size generated grammar."""
    return _synth("synth_de18k", "datok")


@pytest.fixture(scope="session")
def small_tok():
    """Generated grammar of a few hundred states, for fast tests."""
    return _synth("synth_small")


def split_collapse(out: str):
    """The reference's ttokenize: split on \\n+, drop last (datok_test.go:23-33)."""
    toks = re.split("\n+", out)
    return toks[:-1]
