"""Worker script for test_multihost.py: one process of a simulated
2-process (4-device) job.  Validates hdk_jax.parallel.mesh's
multi-host path — jax.distributed.initialize membership, a global mesh
over all hosts' devices, and a distributed group-by whose psum crosses
the process boundary (SURVEY.md §2.8; the reference is single-node)."""

import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def main() -> None:
    pid = int(sys.argv[1])
    port = sys.argv[2]
    from hdk_jax.parallel import mesh as pmesh

    pmesh.init_distributed(f"127.0.0.1:{port}", 2, pid)
    assert jax.process_count() == 2, jax.process_count()

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = pmesh.make_mesh()
    ndev = mesh.devices.size
    assert ndev == 4, ndev

    from hdk_jax.exec.groupby import AggSpec, PerfectHashLayout
    from hdk_jax.exec.masked import MaskedCol
    from hdk_jax.ir.expr import AggKind
    from hdk_jax import types as t
    from hdk_jax.parallel.dist_groupby import dist_groupby_perfect

    # rows 0..15 split across processes (8 local each); key = row % 4
    local = np.arange(8, dtype=np.int64) + pid * 8
    sharding = NamedSharding(mesh, P(pmesh.FRAG_AXIS))
    rows = jax.make_array_from_process_local_data(sharding, local)
    keys = [MaskedCol(rows % 4, None)]
    vals = MaskedCol(rows, None)
    layout = PerfectHashLayout([0], [4], [False])
    specs = [AggSpec(AggKind.COUNT, None, t.int64(False)),
             AggSpec(AggKind.SUM, vals, t.int64())]
    key_cols, agg_cols, exists = dist_groupby_perfect(
        mesh, keys, layout, specs)
    counts = np.asarray(agg_cols[0].data.addressable_data(0))
    sums = np.asarray(agg_cols[1].data.addressable_data(0))
    assert counts.tolist() == [4, 4, 4, 4], counts
    # sum of 0..15 grouped by mod 4: k + (k+4) + (k+8) + (k+12) = 4k+24
    assert sums.tolist() == [24, 28, 32, 36], sums
    print(f"proc{pid} OK", flush=True)

    # ---- full-session end-to-end: process-local ingest -> SQL ->
    # gathered result (multi-controller SPMD: every process runs the
    # identical program over its own table shard) ---------------------
    import pandas as pd
    import hdk_jax

    hdk = hdk_jax.HDK(**{"dist.enable": True})
    n_total = 1000
    rng = np.random.default_rng(5)
    k_all = rng.integers(0, 7, n_total)
    v_all = rng.integers(-50, 50, n_total)
    sl = slice(0, 400) if pid == 0 else slice(400, n_total)  # uneven
    hdk.import_pydict({"k": k_all[sl], "v": v_all[sl]}, name="mt",
                      process_local=True)
    got = hdk.sql("SELECT k, COUNT(*) AS c, SUM(v) AS s FROM mt "
                  "GROUP BY k ORDER BY k").to_pandas()
    df = pd.DataFrame({"k": k_all, "v": v_all})
    exp = (df.groupby("k").agg(c=("k", "size"), s=("v", "sum"))
           .reset_index().sort_values("k").reset_index(drop=True))
    assert got["k"].tolist() == exp["k"].tolist(), got
    assert got["c"].tolist() == exp["c"].tolist(), got
    assert got["s"].tolist() == exp["s"].tolist(), got

    # join: process-local fact x ordinary (host-replicated) dim table
    hdk.import_pydict({"k": list(range(7)),
                       "w": [i * 10 for i in range(7)]}, name="mdim")
    got2 = hdk.sql("SELECT d.w AS w, COUNT(*) AS c FROM mt "
                   "JOIN mdim d ON mt.k = d.k GROUP BY d.w ORDER BY w"
                   ).to_pandas()
    exp2 = (df.assign(w=df["k"] * 10).groupby("w")
            .agg(c=("w", "size")).reset_index())
    assert got2["w"].tolist() == exp2["w"].tolist(), got2
    assert got2["c"].tolist() == exp2["c"].tolist(), got2
    print(f"proc{pid} E2E OK", flush=True)

    # ---- cross-process dictionary unification: string-keyed group-by
    # AND a dict-key join over process-local string columns; each
    # process's shard holds a different (overlapping) string subset, so
    # codes would disagree without the allgather-unify step at ingest
    cities = np.asarray(["nyc", "sfo", "chi", "bos", "lax", "sea"])
    ci_all = cities[rng.integers(0, 6, n_total)]
    amt_all = rng.integers(1, 100, n_total)
    hdk.import_pydict({"city": ci_all[sl], "amt": amt_all[sl]},
                      name="mstr", process_local=True)
    got3 = hdk.sql("SELECT city, COUNT(*) AS c, SUM(amt) AS s FROM mstr "
                   "GROUP BY city ORDER BY city").to_pandas()
    df3 = pd.DataFrame({"city": ci_all, "amt": amt_all})
    exp3 = (df3.groupby("city").agg(c=("city", "size"), s=("amt", "sum"))
            .reset_index().sort_values("city").reset_index(drop=True))
    assert got3["city"].tolist() == exp3["city"].tolist(), got3
    assert got3["c"].tolist() == exp3["c"].tolist(), got3
    assert got3["s"].tolist() == exp3["s"].tolist(), got3
    # dict-key join: process-local fact x replicated dim on the string
    # key (cross-dictionary translation handles the dim's own dict)
    hdk.import_pydict({"city": cities.tolist(),
                       "tz": [-5, -8, -6, -5, -8, -8]}, name="mcity")
    got4 = hdk.sql("SELECT d.tz AS tz, COUNT(*) AS c FROM mstr "
                   "JOIN mcity d ON mstr.city = d.city "
                   "GROUP BY d.tz ORDER BY tz").to_pandas()
    tzmap = dict(zip(cities.tolist(), [-5, -8, -6, -5, -8, -8]))
    exp4 = (df3.assign(tz=df3["city"].map(tzmap)).groupby("tz")
            .agg(c=("tz", "size")).reset_index())
    assert got4["tz"].tolist() == exp4["tz"].tolist(), got4
    assert got4["c"].tolist() == exp4["c"].tolist(), got4
    # string literal filter crosses the unified code space too
    got5 = hdk.sql("SELECT COUNT(*) AS c FROM mstr WHERE city = 'sfo'"
                   ).to_pandas()
    assert got5["c"].iloc[0] == int((df3.city == "sfo").sum()), got5
    print(f"proc{pid} DICT OK", flush=True)


if __name__ == "__main__":
    main()
