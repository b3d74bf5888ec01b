"""The port's ``bench_meshserve`` at its smallest size on the CPU: the JAX
bench's result keys (its recompile counters named for what the port
counts instead, CUDA-graph captures after warmup) and its bars: the
degenerate mesh bit for bit the one-device engine, the sharded engine
within tolerance across a hot swap, no capture after warmup on any engine
or replica incarnation, and no request lost to a replica SIGKILLed under
load. The CPU has one device, so the sharded engine lays two spans on it
and the two replicas share its one slice.
"""

from deeplearninginassetpricing_paperreplication_torch.serving.loadgen import (
    bench_meshserve,
)

# the JAX bench's keys (``…_tpu/serving/loadgen.py::bench_meshserve``) with
# its compile counters renamed: warmup_compile_s → warmup_capture_s,
# compiles → captures, steady_state_recompiles(_max) →
# steady_state_captures(_max); the port adds sharded_positions
JAX_KEYS = {
    "shape", "devices", "mesh", "sharded_mesh", "stock_shards", "n_pairs",
    "engine_load_s", "warmed_programs", "median_infer_ms",
    "paired_median_ratio_single_over_sharded", "bit_identical",
    "bitwise_equal_sharded", "degenerate_bitwise", "sharded_max_abs_diff",
    "tolerance", "hot_swap", "dispatches", "fault_matrix", "note"}
RENAMED = {"warmup_capture_s", "captures", "steady_state_captures",
           "steady_state_captures_max"}
FAULT_KEYS = {"replicas", "mesh", "fleet_stocks", "rate_rps",
              "fleet_startup_s", "n_requests", "n_ok", "dropped_requests",
              "n_retried", "errors", "latency", "replica_meshes",
              "replica_restarts"}


def test_bench_meshserve_smallest_size_holds_its_bars():
    out = bench_meshserve(n_stocks=256, n_features=6, n_macro=3,
                          n_members=2, months=6, n_pairs=4, fleet_stocks=64,
                          fleet_rate_rps=10.0, fleet_seconds=2.0,
                          device="cpu")
    assert set(out) == JAX_KEYS | RENAMED | {"sharded_positions"}
    assert FAULT_KEYS <= set(out["fault_matrix"])
    assert set(out["hot_swap"]) == {"swapped", "reload_s", "max_abs_diff",
                                    "bitwise_equal"}
    assert out["devices"] == 1
    assert out["sharded_mesh"] == "stocks=2" and out["stock_shards"] == 2
    assert out["sharded_positions"] == 2
    assert out["degenerate_bitwise"] == 1
    assert out["sharded_max_abs_diff"] <= out["tolerance"]
    assert out["hot_swap"]["swapped"] is True
    assert out["hot_swap"]["max_abs_diff"] <= out["tolerance"]
    assert out["bit_identical"] == 1
    assert out["warmed_programs"]["single"] == \
        out["warmed_programs"]["sharded"] == 1
    assert out["steady_state_captures_max"] == 0
    assert set(out["steady_state_captures"]) == {
        "single", "sharded", "replica0", "replica1"}
    fm = out["fault_matrix"]
    assert fm["n_requests"] == 20 and fm["dropped_requests"] == 0
    assert fm["errors"] == {}
    assert sum(fm["replica_restarts"]) >= 1
    assert fm["replica_meshes"] == {"replica0": "stocks=1",
                                    "replica1": "stocks=1"}
    assert out["dispatches"]["single"] == 4
    assert out["dispatches"]["sharded"] == 8
