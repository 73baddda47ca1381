"""bench.py's regimes on the port: `python -m grove_tpu_torch.bench`.

One module per family of bench.py's regimes, each function named as its
counterpart there, each taking `device=` (None: the card) and passing it
to every engine and Harness it builds:

  shapes        make_cluster, make_gangs, make_tier_cluster,
                make_tier_gangs (from grove_tpu_torch.stress), p50,
                wall_stats, interleaved_ab
  solve         bench_solve (bench.py's `main` from the stress cluster
                on: the fused, delta, full and pallas regimes, the serial
                baseline, grouped, the device split, the incremental and
                pipelined probes, the scale probes), bench_equivalence
  tiers         bench_scale_tier
  controlplane  bench_controlplane, bench_controlplane_sharded,
                churn_workload, _churn_pcs, bench_churn,
                _trace_critical_path, bench_aggregate_overhead
  store         bench_store, bench_recovery, bench_replication
  federation    bench_federation
  serving       bench_diurnal
  defrag        bench_defrag
  tenants       bench_tenants
  stream        _stream_schedule, _stream_run, bench_stream
  service       bench_service
  cli           bench.py's parser and dispatch (`main(argv)`), with
                `--device`; the keys of the JSON line that differ from
                bench.py's are listed there

Importing the package runs nothing and touches no device.
"""
