"""Test configuration: force an 8-device CPU platform.

This is the JAX idiom for testing multi-device sharding without the
accelerator (SURVEY.md §4): all mesh/pjit tests run against 8 virtual CPU
devices. The platform is also set through jax.config, which still takes
effect when jax was imported before this file, as long as no backend has
been initialised yet.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.RandomState(0)


# quick/slow tiers (VERDICT r1 item 10): `pytest -m quick` < 5 min on this
# 1-core box; `-m slow` is the compile-heavy remainder (zoo contract sweep,
# convergence, e2e CLI, spatial sharding). Assignments from the measured
# --durations=0 of the full suite (r2): every file below has multi-minute
# items; named exceptions keep one fast smoke per area in the quick tier.
SLOW_FILES = {
    "test_convergence.py",
    "test_e2e_cli.py",
    "test_golden_run.py",
    "test_profiling.py",
    "test_spatial_sharding.py",
    "test_models.py",
}
SLOW_TESTS = {
    "test_builders_synthetic_fallback",                  # 100 s
    "test_predict_matches_argmax_of_logits[unet]",       # 23 s
    "test_predict_matches_argmax_of_logits[segnet]",     # 19 s
    "test_predict_matches_argmax_of_logits[linknet]",    # 10 s
    "test_predict_matches_argmax_of_logits[fastscnn]",   # 10 s
    "test_predict_matches_argmax_of_logits[sqnet]",      # 24 s
    "test_predict_matches_argmax_of_logits[erfnet]",     # 21 s
    "test_predict_matches_argmax_of_logits[fssnet]",     # 20 s
    "test_predict_matches_argmax_of_logits[espnet]",     # 14 s
    "test_predict_matches_argmax_of_logits[esnet]",      # 13 s
    "test_conv_transpose_subpixel_matches_zero_insert",  # 12 s
    # full-model parity sweeps: unit-level coverage of the same code paths
    # stays quick (per-block folded/pieces/scan tests)
    "test_cgnet_grad_flows_through_pieces",              # 55 s
    "test_espnet_grad_flows_through_pieces",
    "test_dabnet_grad_flows_through_pieces",
    "test_dabnet_full_folded_matches_plain",             # 18 s
    "test_fpenet_full_folded_matches_plain",             # 18 s
    "test_espnetv2_full_folded_matches_plain",           # 25 s
    "test_cgnet_full_folded_matches_plain",              # 12 s
    "test_fpenet_groupmajor_folded_matches_plain_train",  # 30 s
    "test_fpenet_groupmajor_folded_matches_plain_eval",  # 40 s
    "test_fpenet_groupmajor_folded_grads_match",         # 108 s
    "test_fpenet_predict_matches_argmax_of_logits",      # 25 s
    "test_predict_matches_argmax_of_logits[enet]",       # 21 s (espnet_c 7 s stays as the quick smoke)
    "test_scan_under_jit_and_grad",                      # 11 s
    "test_espnet_c_full_fused_hff_matches_plain",
    "test_sharded_eval_matches_unsharded_and_compiles_once",  # 24 s
    "test_scanned_pattern_body_matches_unrolled",        # 15 s
    "test_general_folded_conv_parity",                   # 13 s
    # r4 rebalance (quick tier had crept to 6 min): the two heaviest
    # resize-argmax items move to slow;
    # test_resize_argmax_matches_f32_oracle stays as the quick smoke
    "test_model_predict_falls_back_unfused_on_cpu",      # 48 s
    "test_resize_argmax_bf16_near_tie_rate",             # 35 s
    "test_predict_matches_argmax_of_logits[espnet_c]",   # 14 s (dabnet ~4 s becomes the quick smoke)
    "test_resize_argmax_matches_f32_oracle[8]",          # 14 s (factors 2/3/4 stay quick)
    "test_lovasz_hist_matches_sort",                     # 8 s (perfect-prediction test is the quick smoke)
    "test_resize_ce_matches_materialized[8-hw1]",        # s=8 variant; s=4 stays quick
    # r5 rebalance: the new whole-model folded-stem parity runs (60-150 s
    # each) move to slow; op/unit-level w_fold parity stays quick
    "test_contextnet_folded_stem_model_parity",          # 66 s
    "test_convbnact_folded_stem_unit_parity",            # 30 s
    "test_scale_then_crop_matches_cv2_oracle[0.5]",      # pad-path variant
    # (other scales ~5 s each stay quick: they are the PARITY #5 oracle)
}
QUICK_OVERRIDES = set()   # test_enet_jit_forward grew to 25 s — now slow


def pytest_collection_modifyitems(config, items):
    # This hook is the SINGLE source of truth for quick/slow. Never add
    # pytest.mark.quick/slow in test files: `-m quick` matches any item
    # CARRYING the marker, so a file-level quick mark on a conftest-slow
    # test leaks it into the quick tier (this shadowed ~4 min of slow
    # tests until r2).
    for item in items:
        if any(m.name in ("quick", "slow") for m in item.iter_markers()):
            # not a bare assert: that guard vanishes under `python -O`
            raise pytest.UsageError(
                f"{item.nodeid}: mark quick/slow only via conftest")
        base = getattr(item, "originalname", None) or item.name
        slow = (item.fspath.basename in SLOW_FILES or base in SLOW_TESTS
                or item.name in SLOW_TESTS) and base not in QUICK_OVERRIDES
        item.add_marker(pytest.mark.slow if slow else pytest.mark.quick)
