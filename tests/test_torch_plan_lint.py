"""The static plan verifier of the PyTorch package
(``repro_torch.analysis.plan_verifier``, ``python -m repro_torch.plan
lint``).

The cases of the JAX package's ``tests/test_plan_lint.py`` on the port's
copy: the pristine golden fixture (read only) passes; seeded mutations of
it — corrupted mapping permutation, wrong digests, unknown schema
version, out-of-memory confs, unschedulable pipelines — are each flagged
by the intended PLN rule, without re-running any search.  Beside them: a
plan the port makes (``device="cpu"``) lints clean through the CLI, with
and without its live spec and bandwidth matrix, and the port's verifier
gives the reference's findings on every mutation.
"""
import copy
import json
from pathlib import Path

import numpy as np
import pytest

from repro.analysis import verify_plan_dict as r_verify_plan_dict
from repro_torch.analysis import verify_plan_dict, verify_plan_file
from repro_torch.core import profile_bandwidth
from repro_torch.core.cluster import A100_TIER, V100_TIER, mixed_fleet_spec

TESTS = Path(__file__).resolve().parent
GOLDEN = TESTS / "data" / "golden_plan_v5.json"

# the live spec the golden fixture was generated against
# (tests/data/gen_golden_plan.py), built by the port
SPEC = mixed_fleet_spec("mixed-a100-v100-16x1", 16, (A100_TIER, V100_TIER),
                        (0.5, 0.5), gpus_per_node=1, seed=47)


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text(encoding="utf-8"))


def _errors(issues):
    return sorted({i.rule for i in issues if i.severity == "error"})


# ------------------------------------------------------------ pristine plan

def test_pristine_golden_passes(golden):
    issues = verify_plan_dict(golden)
    assert _errors(issues) == []
    assert not any(i.severity == "warning" for i in issues)


def test_pristine_golden_passes_against_live_spec(golden):
    """With the generating spec and bandwidth matrix in hand, the digest
    cross-checks go live and still pass."""
    bw, _ = profile_bandwidth(SPEC)
    issues = verify_plan_dict(golden, spec=SPEC, bw=bw)
    assert _errors(issues) == []
    # the bandwidth digest was actually checked against the matrix, so no
    # format-only note (the golden has mem_pred=null, so a PLN005 note
    # about the skipped OOM check is expected and fine)
    assert not any("format only" in i.message for i in issues)


def test_verify_plan_file_matches_dict_path(golden):
    assert _errors(verify_plan_file(GOLDEN)) == []


# -------------------------------------------------- seeded mutation classes

def _mutate(golden, fn):
    """The port's findings on a mutated copy, held equal to the
    reference verifier's findings on the same dict."""
    m = copy.deepcopy(golden)
    fn(m)
    got = verify_plan_dict(m)
    want = r_verify_plan_dict(copy.deepcopy(m))
    assert [(i.rule, i.severity, i.where, i.message) for i in got] == \
        [(i.rule, i.severity, i.where, i.message) for i in want]
    return got


def test_corrupted_mapping_duplicate_entry(golden):
    def fn(m):
        m["best"]["mapping"]["data"][0] = m["best"]["mapping"]["data"][1]
    assert "PLN004" in _errors(_mutate(golden, fn))


def test_corrupted_mapping_out_of_range_rank(golden):
    def fn(m):
        m["best"]["mapping"]["data"][3] = 999
    assert "PLN004" in _errors(_mutate(golden, fn))


def test_mapping_shape_conf_mismatch(golden):
    def fn(m):
        m["best"]["mapping"]["shape"] = [2, 2, 1, 4]
    assert "PLN004" in _errors(_mutate(golden, fn))


def test_unknown_schema_version(golden):
    issues = _mutate(golden, lambda m: m.__setitem__("version", 99))
    assert "PLN001" in _errors(issues)


def test_wrong_tier_digest(golden):
    def fn(m):
        m["provenance"]["tiers"]["digest"] = "0" * 64
    assert "PLN007" in _errors(_mutate(golden, fn))


def test_wrong_bw_digest_format(golden):
    def fn(m):
        m["provenance"]["bw_digest"] = "not-a-sha256"
    assert "PLN006" in _errors(_mutate(golden, fn))


def test_bw_matrix_mismatch_against_live_matrix(golden):
    bw, _ = profile_bandwidth(SPEC)
    m = copy.deepcopy(golden)
    issues = verify_plan_dict(m, spec=SPEC, bw=bw * 1.01)
    assert "PLN006" in _errors(issues)


def test_oom_conf_flagged(golden):
    def fn(m):
        m["best"]["mem_pred"] = 5.0e10          # > the 32 GB V100 floor
    assert "PLN005" in _errors(_mutate(golden, fn))


def test_unschedulable_pipeline(golden):
    # golden best is pp=8; bs_micro=4 gives n_mb = 32/(4*dp) < pp
    def fn(m):
        m["best"]["conf"]["bs_micro"] = 4
    assert "PLN003" in _errors(_mutate(golden, fn))


def test_degree_product_mismatch(golden):
    def fn(m):
        m["best"]["conf"]["tp"] = 2             # product != n_gpus now
    errs = _errors(_mutate(golden, fn))
    assert "PLN002" in errs


def test_spec_cross_check(golden):
    wrong = mixed_fleet_spec("mixed-a100-v100-16x1", 32,
                             (A100_TIER, V100_TIER), (0.5, 0.5),
                             gpus_per_node=1, seed=47)
    issues = verify_plan_dict(golden, spec=wrong)
    assert "PLN008" in _errors(issues)


def test_ranked_candidates_are_checked_too(golden):
    def fn(m):
        m["ranked"][-1]["mapping"]["data"][0] = \
            m["ranked"][-1]["mapping"]["data"][1]
    issues = _mutate(golden, fn)
    bad = [i for i in issues if i.rule == "PLN004"]
    assert bad and all("ranked" in i.where for i in bad)


def test_unknown_schedule_name(golden):
    def fn(m):
        m["best"]["schedule"] = "gpipe"
    assert "PLN009" in _errors(_mutate(golden, fn))


def test_schedule_vpp_inconsistency(golden):
    # vpp=1 conf claiming interleaved-1f1b, and vpp=2 claiming plain 1f1b
    def claims_interleaved(m):
        m["best"]["schedule"] = "interleaved-1f1b"
    assert "PLN009" in _errors(_mutate(golden, claims_interleaved))

    def claims_plain(m):
        m["best"]["conf"]["vpp"] = 2
    assert "PLN009" in _errors(_mutate(golden, claims_plain))


def _with_partition(m):
    """Attach a valid uniform partition to the golden best (pp=8, 12
    layers → ceil-first boundaries)."""
    m["best"]["partition"] = {
        "n_layers": 12, "boundaries": [2, 4, 6, 8, 9, 10, 11, 12]}


def test_valid_partition_passes(golden):
    issues = _mutate(golden, _with_partition)
    assert "PLN009" not in _errors(issues)


def test_partition_boundaries_not_increasing(golden):
    def fn(m):
        _with_partition(m)
        m["best"]["partition"]["boundaries"][3] = 6   # ties the previous
    assert "PLN009" in _errors(_mutate(golden, fn))


def test_partition_does_not_cover_all_layers(golden):
    def fn(m):
        _with_partition(m)
        m["best"]["partition"]["boundaries"][-1] = 11  # one layer dropped
    assert "PLN009" in _errors(_mutate(golden, fn))


def test_partition_chunk_count_mismatch(golden):
    def fn(m):
        _with_partition(m)
        del m["best"]["partition"]["boundaries"][0]    # 7 chunks, pp=8
    assert "PLN009" in _errors(_mutate(golden, fn))


def test_partition_malformed_dict(golden):
    def fn(m):
        m["best"]["partition"] = {"boundaries": [2, 4]}  # no n_layers
    assert "PLN009" in _errors(_mutate(golden, fn))


def test_malformed_json_file(tmp_path):
    p = tmp_path / "broken.json"
    p.write_text("{not json", encoding="utf-8")
    issues = verify_plan_file(p)
    assert _errors(issues) == ["PLN000"]


def test_infeasible_plan_is_not_an_error(golden):
    m = copy.deepcopy(golden)
    m["best"] = None
    m["ranked"] = []
    assert _errors(verify_plan_dict(m)) == []


# --------------------------------------------------------------------- CLI

def test_cli_lint_pristine_and_mutated(tmp_path, capsys):
    from repro_torch.plan import main as plan_main
    assert plan_main(["lint", str(GOLDEN)]) == 0
    captured = capsys.readouterr()
    assert "OK" in captured.err                 # verdict line on stderr

    m = json.loads(GOLDEN.read_text(encoding="utf-8"))
    m["best"]["conf"]["bs_micro"] = 4
    bad = tmp_path / "mutated.json"
    bad.write_text(json.dumps(m), encoding="utf-8")
    assert plan_main(["lint", str(bad)]) == 1
    captured = capsys.readouterr()
    assert "PLN003" in captured.out
    assert "FAIL" in captured.err


def test_cli_lint_json_format(capsys):
    from repro_torch.plan import main as plan_main
    assert plan_main(["lint", str(GOLDEN), "--format", "json"]) == 0
    issues = json.loads(capsys.readouterr().out)
    assert isinstance(issues, list)
    assert not any(i["severity"] == "error" for i in issues)
    assert all({"rule", "severity", "where", "message"} <= set(i)
               for i in issues)


# ------------------------------------------------- a plan the port makes

def test_cli_lint_passes_a_port_made_plan(tmp_path, capsys):
    """``python -m repro_torch.plan plan --device cpu`` writes a plan that
    ``lint`` passes against its recorded provenance, and against the live
    cluster preset with its profiled bandwidth matrix."""
    from repro_torch.plan import CLUSTERS
    from repro_torch.plan import main as plan_main
    out = tmp_path / "plan.json"
    assert plan_main(["plan", "--config", "gpt-1.1b", "--reduced",
                      "--cluster", "mid-range", "--nodes", "1",
                      "--seq", "128", "--bs-global", "16", "--sa-iters",
                      "40", "--device", "cpu", "-o", str(out)]) == 0
    capsys.readouterr()
    assert plan_main(["lint", str(out)]) == 0
    assert "OK" in capsys.readouterr().err
    bw_path = tmp_path / "bw.npy"
    np.save(bw_path, profile_bandwidth(CLUSTERS["mid-range"].with_nodes(1))[0])
    assert plan_main(["lint", str(out), "--cluster", "mid-range",
                      "--nodes", "1", "--bw", str(bw_path),
                      "--format", "json"]) == 0
    issues = json.loads(capsys.readouterr().out)
    assert not any(i["severity"] == "error" for i in issues)
    assert not any("format only" in i["message"] for i in issues)
    # the same plan against a cluster it was not made for fails
    assert plan_main(["lint", str(out), "--cluster", "mid-range",
                      "--nodes", "2"]) == 1
    assert "PLN008" in capsys.readouterr().out
