"""Diagnostic runs on the CPU that PERF.md's numbers for the port stand
beside: the JAX package's figures on the same bytes, and the split of
both packages' tour arms.  Not a test: it imports both packages, as the
port's tests do, and each run takes minutes.

  python tests/diag_reference.py circuit PHASE WS [ARGS...]
      scripts/exp_circuit.py PHASE WS ARGS with its persistent compilation
      cache left off (xrsfm_tpu.enable_compilation_cache replaced by a
      no-op), so the run reads and writes nothing outside WS.
  python tests/diag_reference.py edge_bias WS [--seq_only]
          [--key_offset K] [--dump OUT.npz] [ARGS...]
      scripts/exp_edge_bias.py on WS (the 250-frame circuit written by
      utils/synth.write_kitti_workspace(WS, 250, 3) when WS lacks fp.bin;
      ARGS go to the script).  --seq_only keeps the circuit's sequential
      pairs (|i - j| <= SEQ_WINDOW) and drops the loop closures, as the
      port's tools.exp_edge_bias --seq_only does: the script's docstring
      names the flag but its parser lacks it, so the map's pairs are
      filtered before the script measures them.  --key_offset seeds pair
      k's RANSAC with PRNGKey(k + K) (the script's: K = 0).  --dump
      writes the per-pair errors (errs_raw, errs_clean) that the script's
      percentiles are taken over.
  python tests/diag_reference.py edge_bias_port WS [--seq_only]
          [--chunk N] [--key_offset K] [--device cpu] --dump OUT.npz
      the port's tools.exp_edge_bias on WS with N pairs a batched call
      (1: each list alone, unpadded) and pair k's generator seeded with
      k + K; writes the per-pair errors, the pairs and the clean lists'
      sizes.
  python tests/diag_reference.py tour_workspace WS --n_frames N
          --distractors D [--seed 1]
      the street tour of scripts/run_unordered_bench.py --scene tour
      (utils/synth.write_unordered_workspace, the script's bytes)
  python tests/diag_reference.py tour_split --pkg jax|port WS OUT.json
          [--strategies retrieval,covisibility] [--threads N]
      each arm as the bench scripts run it (run_matching.main on a copy of
      WS's ftr.bin and size.bin), with timers wrapped around the
      package's functions at run time: VLAD (feature/retrieval.
      build_retrieval), every match_and_verify_pairs call, and inside it
      the descriptor matching (_match_chunk_resident) and the RANSAC
      verification (_fundamental_ransac_batch), each timed to its result
      (the JAX package's dispatches are waited for, so its chunks no
      longer overlap the host's work).  Host work inside the calls is
      their total less matching and RANSAC; the expansion's search is the
      arm's wall less VLAD and the calls.  Writes the split, the counts
      and the verified pairs; --threads sets torch's intra-op threads
      (port only; default: torch's own).
"""

import argparse
import importlib.util
import json
import os
import shutil
import sys
import time


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _script(name):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", name + ".py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


def circuit(args):
    import xrsfm_tpu

    xrsfm_tpu.enable_compilation_cache = lambda *a, **k: None
    script = _script("exp_circuit")
    sys.argv = ["exp_circuit.py"] + list(args)
    script.main()


def edge_bias(ws, seq_only, key_offset, dump, args):
    import jax
    import numpy as np

    from xrsfm_tpu_torch.utils import synth

    jax.config.update("jax_platforms", "cpu")
    if not os.path.exists(os.path.join(ws, "fp.bin")):
        synth.write_kitti_workspace(ws, 250, 3)
    script = _script("exp_edge_bias")
    from xrsfm_tpu.pipelines import run_reconstruction as RR

    if seq_only:
        build = RR.build_map

        def seq_map(*a, **kw):
            m = build(*a, **kw)
            m.pairs = [p for p in m.pairs
                       if abs(p[1] - p[0]) <= synth.SEQ_WINDOW]
            return m

        RR.build_map = seq_map
    prng_key = jax.random.PRNGKey
    jax.random.PRNGKey = lambda k: prng_key(k + key_offset)
    # the script takes its p90s of the raw, then the clean errors
    taken, percentile = [], np.percentile
    np.percentile = lambda a, q, *x, **k: (taken.append(np.array(a)),
                                           percentile(a, q, *x, **k))[1]
    sys.argv = ["exp_edge_bias.py", ws] + list(args)
    try:
        script.main()
    finally:
        np.percentile = percentile
    if dump:
        np.savez(dump, errs_raw=taken[0], errs_clean=taken[1])


def edge_bias_port(ws, seq_only, chunk, key_offset, device, dump):
    import numpy as np

    from xrsfm_tpu_torch.tools import exp_edge_bias as EB

    measure = EB.measure
    EB.CHUNK = chunk
    EB.measure = lambda tables, keys, *a: measure(
        tables, np.asarray(keys) + key_offset, *a)
    r = EB.run(ws, seq_only=seq_only, device=device)
    np.savez(dump, errs_raw=r["errs_raw"], errs_clean=r["errs_clean"],
             edges=np.array(r["edges"]), clean_edges=np.array(
                 r["clean_edges"]), clean_sizes=np.array(r["clean_sizes"]))


def _timed(store, key, fn, wait):
    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        out = wait(fn(*a, **kw))
        store[key] = store.get(key, 0.0) + time.perf_counter() - t0
        store[key + "_calls"] = store.get(key + "_calls", 0) + 1
        return out
    return wrapped


def tour_split(pkg, ws, out, strategies, threads):
    if pkg == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from xrsfm_tpu.feature import matching as FM
        from xrsfm_tpu.feature import retrieval as RET
        from xrsfm_tpu.pipelines import run_matching as RM

        wait = jax.block_until_ready
        kw = {}
    else:
        import torch

        from xrsfm_tpu_torch.feature import matching as FM
        from xrsfm_tpu_torch.feature import retrieval as RET
        from xrsfm_tpu_torch.pipelines import run_matching as RM

        if threads:
            torch.set_num_threads(threads)
        wait = (lambda x: x)  # the CPU runs every op to its end
        kw = {"device": "cpu"}
    from xrsfm_tpu_torch.utils import io_features as IOF

    n_total = len(IOF.read_features(os.path.join(ws, "ftr.bin"),
                                    with_descs=False))
    result = {"pkg": pkg, "frames": n_total, "arms": {}}
    if pkg == "port":
        import torch

        result["torch_threads"] = torch.get_num_threads()
    for mtype in strategies:
        t = {}
        orig = (FM._match_chunk_resident, FM._fundamental_ransac_batch,
                FM.match_and_verify_pairs, RET.build_retrieval)
        FM._match_chunk_resident = _timed(t, "match", orig[0], wait)
        FM._fundamental_ransac_batch = _timed(t, "ransac", orig[1], wait)
        FM.match_and_verify_pairs = _timed(t, "mv", orig[2], lambda x: x)
        RET.build_retrieval = _timed(t, "vlad", orig[3], lambda x: x)
        d = os.path.join(os.path.dirname(out), f"{pkg}_{mtype}")
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(os.path.join(d, "images"))
        shutil.copy(os.path.join(ws, "ftr.bin"), d)
        shutil.copy(os.path.join(ws, "size.bin"), d)
        for i in range(n_total):
            open(os.path.join(d, "images", f"img{i:05d}.png"), "w").close()
        st = {}
        t0 = time.perf_counter()
        verified = RM.main(os.path.join(d, "images"), "", mtype, d, stats=st,
                           **kw)
        wall = time.perf_counter() - t0
        (FM._match_chunk_resident, FM._fundamental_ransac_batch,
         FM.match_and_verify_pairs, RET.build_retrieval) = orig
        result["arms"][mtype] = {
            "pairs_proposed": st.get("pairs_proposed", -1),
            "verified_pairs": len(verified),
            "wall_s": wall,
            "vlad_s": t.get("vlad", 0.0),
            "search_s": wall - t.get("vlad", 0.0) - t.get("mv", 0.0),
            "match_verify_calls": t.get("mv_calls", 0),
            "match_verify_s": t.get("mv", 0.0),
            "matching_s": t.get("match", 0.0),
            "matching_chunks": t.get("match_calls", 0),
            "ransac_s": t.get("ransac", 0.0),
            "ransac_chunks": t.get("ransac_calls", 0),
            "host_s": (t.get("mv", 0.0) - t.get("match", 0.0)
                       - t.get("ransac", 0.0)),
            "pairs": sorted([int(p.id1), int(p.id2)] for p in verified),
        }
        print(json.dumps({k: v for k, v in result["arms"][mtype].items()
                          if k != "pairs"}), flush=True)
    with open(out, "w") as f:
        json.dump(result, f)


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("circuit")
    e = sub.add_parser("edge_bias")
    e.add_argument("ws")
    e.add_argument("--seq_only", action="store_true")
    e.add_argument("--key_offset", type=int, default=0)
    e.add_argument("--dump", default="")
    p = sub.add_parser("edge_bias_port")
    p.add_argument("ws")
    p.add_argument("--seq_only", action="store_true")
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--key_offset", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dump", required=True)
    w = sub.add_parser("tour_workspace")
    w.add_argument("ws")
    w.add_argument("--n_frames", type=int, required=True)
    w.add_argument("--distractors", type=int, required=True)
    w.add_argument("--seed", type=int, default=1)
    s = sub.add_parser("tour_split")
    s.add_argument("--pkg", choices=["jax", "port"], required=True)
    s.add_argument("ws")
    s.add_argument("out")
    s.add_argument("--strategies", default="retrieval,covisibility")
    s.add_argument("--threads", type=int, default=0)
    a, rest = ap.parse_known_args()
    if a.cmd == "circuit":
        circuit(rest)
    elif a.cmd == "edge_bias":
        edge_bias(a.ws, a.seq_only, a.key_offset, a.dump, rest)
    elif rest:
        ap.error(f"unrecognized arguments: {rest}")
    elif a.cmd == "edge_bias_port":
        edge_bias_port(a.ws, a.seq_only, a.chunk, a.key_offset, a.device,
                       a.dump)
    elif a.cmd == "tour_workspace":
        from xrsfm_tpu_torch.utils import synth

        synth.write_unordered_workspace(a.ws, "tour", a.n_frames, a.seed,
                                        a.distractors)
    else:
        tour_split(a.pkg, a.ws, a.out, a.strategies.split(","), a.threads)


if __name__ == "__main__":
    main()
