"""MHAP-compatible command line for the PyTorch + CUDA port.

    python -m mhap_tpu_torch.cli.main -s reads.fa|box.dat [-q queries]
        [-f kmers.txt[.gz] [--supress-noise 0|1|2] [--repeat-weight W]
         [--no-tf] ...]
    python -m mhap_tpu_torch.cli.main -p fasta_dir_or_file -q dat_dir ...

Same flags, presets, validation and stderr stats block as the JAX
package's CLI (``cli/options.py`` holds the port's copy of its parser),
with the port's ``TorchOverlapper`` on the GPU in place of the JAX
pipeline.  ``-s`` and each file of ``-q`` (a file or a directory) may be
FASTA/FASTQ or ``.dat`` sketches; ``-p`` sketches each file of its
argument into ``<name>.dat`` in the ``-q`` directory (the path Canu
runs: ``-p`` per block, then ``-s block.dat -q dir``).  ``-f`` takes a
k-mer frequency file at every ``--supress-noise`` mode; modes 1 and 2
hold the file's k-mers in the reference's Guava bloom filter, as the JAX
CLI does.

``--backend sharded`` runs ``parallel/sharded.ShardedOverlapper``, one
rank a GPU:

    torchrun --nproc-per-node N -m mhap_tpu_torch.cli.main \
        --backend sharded -s reads.fa

Under torchrun (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) the ranks join
through ``env://`` with NCCL, rank r on ``cuda:LOCAL_RANK``; without that
environment the run is one rank.  Rank 0 prints the lines and the stats
block, its stats summed over the ranks.

``--backend oracle`` runs the numpy reference (``oracle/pipeline.py``)
on the host, as the JAX CLI does: it touches no device and runs on a
machine without a GPU.  It reads FASTA/FASTQ only (no ``.dat``, no
``-p``), and its stats block is the one line ``Total matches found: N``.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
import time

import numpy as np

from ..io import datstore
from ..io.fasta import list_sequence_files, open_text
from ..io.formats import write_lines
from ..utils import trace
from .options import PRESETS, _load_reads, build_options, options_to_cfg


def main(argv=None, device="cuda", comm=None) -> int:
    """Runs the command line ``argv``; the overlapper runs on ``device``
    (the GPU unless a caller, such as a test, asks for the CPU), except
    under ``--backend oracle``, which runs on the host.
    ``--backend sharded`` runs on the ranks of ``comm`` (a
    ``parallel.comm.Comm``) if given, else on those ``sharded_comm``
    joins."""
    argv = sys.argv[1:] if argv is None else argv
    o = build_options()
    if not o.process(argv):
        return 0
    st = o.get("--settings").value
    if st < 0 or st > 3:
        print("Please enter valid --settings flag. See options below:")
        print(o.help_menu())
        return 1
    if st in PRESETS:
        for name, val in PRESETS[st].items():
            if not o.get(name).is_set:
                o.get(name).value = val
    s_file, p_file, q_file = (o.get(f).value for f in ("-s", "-p", "-q"))
    if not s_file and not p_file:
        print("Please set the -s or the -p options. See options below:")
        print(o.help_menu())
        return 1
    if p_file and not q_file:
        print("Please set the -q option. See options below:")
        print(o.help_menu())
        return 1
    for flag in ("-p", "-s", "-q", "-f"):
        v = o.get(flag).value
        if v and not os.path.exists(v):
            print(f"Could not find requested file/folder: {v}")
            return 1
    checks = [
        (o.get("--num-threads").value <= 0,
         "Number of threads must be positive."),
        (o.get("-k").value <= 0, "k-mer size must be positive."),
        (o.get("--num-min-matches").value <= 0,
         "Minimum number of matches must be positive."),
        (o.get("--min-store-length").value < 0,
         "The minimum read length stored must be >=0."),
        (o.get("--repeat-idf-scale").value < 1.0,
         "The minimum repeat idf scale must be >=1.0."),
        (o.get("--max-shift").value < -1.0,
         "The minimum shift must be greater than -1."),
        (not 0.0 <= o.get("--threshold").value <= 1.0,
         "The second stage filter threshold must be 0<=threshold<=1.0."),
        (not 0 <= o.get("--supress-noise").value <= 2,
         "The --supress-noise parameter must be in [0,2]."),
    ]
    for bad, msg in checks:
        if bad:
            print(msg)
            return 1
    backend = o.get("--backend").value
    if backend not in ("device", "sharded", "oracle"):
        raise SystemExit(f"unknown --backend {backend}: device, sharded or "
                         "oracle")
    own = backend == "sharded" and comm is None
    if own:
        comm = sharded_comm(device)
    try:
        # ranks other than 0 print neither lines nor stats
        with (contextlib.redirect_stderr(io.StringIO())
              if comm is not None and comm.rank else
              contextlib.nullcontext()):
            print("Running with these settings:", file=sys.stderr)
            print(o, file=sys.stderr)
            t_total = time.time()
            with trace.span("job") as job:
                if backend == "oracle":
                    run_oracle(o)
                else:
                    ov = build_overlapper(o, device, comm if backend ==
                                          "sharded" else None)
                    if p_file:
                        run_precompute(o, ov)
                    else:
                        run_overlap(o, ov)
                    job.set_counters(ov.stats)
                    job.set_counters(ov.m4_counts)
            print(f"Total time (s): {time.time() - t_total}",
                  file=sys.stderr)
    finally:
        if own:
            comm.close()
    return 0


def sharded_comm(device="cuda"):
    """The ranks of ``--backend sharded``: under torchrun's environment
    its group through ``env://``, on ``cuda:LOCAL_RANK`` with NCCL;
    without it a group of one rank on ``device``.  A CPU ``device`` (the
    tests) runs the collectives with gloo."""
    import torch

    from ..parallel import comm as _comm

    dev = torch.device(device)
    backend = "gloo" if dev.type == "cpu" else "nccl"
    if "WORLD_SIZE" not in os.environ:
        return _comm.single(backend, device)
    if dev.type == "cuda":
        local = int(os.environ["LOCAL_RANK"])
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local} but torch sees "
                f"{torch.cuda.device_count()} CUDA devices")
        dev = torch.device("cuda", local)
    return _comm.init(backend, int(os.environ["RANK"]),
                      int(os.environ["WORLD_SIZE"]), dev,
                      init_method="env://")


def load_filter(o, oracle: bool = False):
    """The ``-f`` file as an ``io.filter.FrequencyCounts`` (the device
    path's reader), or as the oracle's ``oracle.filter.FrequencyCounts``
    when ``oracle``; None without ``-f`` (mhap_tpu/cli/main.py
    load_filter)."""
    if oracle:
        from ..oracle.filter import FrequencyCounts
    else:
        from ..io.filter import FrequencyCounts

    path = o.get("-f").value
    if not path:
        return None
    rw = o.get("--repeat-weight").value
    offset = rw if 0.0 <= rw < 1.0 else 0.0
    t0 = time.time()
    print(f"Reading in filter file {path}.", file=sys.stderr)
    with trace.span("load"), open_text(path) as f:
        fc = FrequencyCounts(
            f, o.get("--filter-threshold").value, offset,
            o.get("--supress-noise").value, o.get("--no-tf").value,
            o.get("--repeat-idf-scale").value, not o.get("--no-rc").value,
            # the reference keeps the file's k-mers in a Guava bloom
            # filter (FrequencyCounts.java:137); so does the JAX CLI
            use_bloom=True)
    print(f"Time (s) to read filter file: {time.time() - t0}",
          file=sys.stderr)
    return fc


def build_overlapper(o, device="cuda", comm=None):
    """The run's ``TorchOverlapper`` with its ``-f`` filter, if any; a
    ``ShardedOverlapper`` on the ranks of ``comm`` if given."""
    from ..pipeline.freqfilter import VectorFrequencyFilter
    from ..pipeline.overlapper import TorchOverlapper

    fc = load_filter(o)
    if comm is not None:
        from ..parallel.sharded import ShardedOverlapper

        vf = VectorFrequencyFilter(fc, comm.device) if fc is not None \
            else None
        return ShardedOverlapper(comm, options_to_cfg(o), kmer_filter=vf)
    vf = VectorFrequencyFilter(fc, device) if fc is not None else None
    return TorchOverlapper(options_to_cfg(o), device, kmer_filter=vf)


def run_overlap(o, ov) -> None:
    """Self/query loop and final stats of mhap_tpu.cli.main.run_overlap
    (:320-450) on the port's overlapper ``ov``."""
    store_full_id = o.get("--store-full-id").value
    do_rc = not o.get("--no-rc").value
    s_file, q_file = o.get("-s").value, o.get("-q").value
    no_self, paf = o.get("--no-self").value, o.get("--paf").value
    t0 = time.time()
    print("Processing files for storage in reverse index...",
          file=sys.stderr)
    if s_file.endswith(".dat"):
        box = ov.read_dat(s_file)
    else:
        headers, reads = _load_reads(s_file, store_full_id)
        box = ov.sketch_reads(reads, headers, do_rc=do_rc)
    n_box = box.n_real
    print(f"Processed {n_box} unique sequences (fwd and rev).",
          file=sys.stderr)
    print(f"Time (s) to read and hash from file: {time.time() - t0}",
          file=sys.stderr)

    out = sys.stdout
    index = ov._build_index(box)
    if not no_self or not q_file:
        t0 = time.time()
        q_sel = np.nonzero(box.is_fwd)[0]
        write_lines(ov._gather_lines(
            ov._find_matches(box, index, box, q_sel, True)), out, paf)
        print(f"Time (s) to score and output to self: {time.time() - t0}",
              file=sys.stderr)
    offset = n_box // 2
    if q_file:
        for qf in list_sequence_files(q_file):
            t0 = time.time()
            with trace.span("query"):
                if qf.endswith(".dat"):
                    queries = ov.read_dat(qf, offset, fwd_only=True)
                else:
                    qh, qreads = _load_reads(qf, store_full_id)
                    queries = ov.sketch_reads(qreads, qh, offset=offset,
                                              do_rc=False)
                trace.count("query_files", 1)
                trace.count("query_rows", len(queries))
                q_sel = np.arange(len(queries))
                write_lines(ov._gather_lines(ov._find_matches(
                    box, index, queries, q_sel, False)), out, paf)
            offset += len(queries)
            print(f"Processed {len(queries)} to sequences.",
                  file=sys.stderr)
            print(f"Time (s) to score, hash to-file, and output: "
                  f"{time.time() - t0}", file=sys.stderr)
    out.flush()
    # final stats block, field-for-field with MhapMain.outputFinalStat
    st = ov.total_stats()
    size = box.n_real
    searched = float(st["sequences_searched"])
    hit = float(st["sequences_hit"])
    compared = float(st["sequences_fully_compared"])
    matches = float(st["matches_processed"])

    def jdiv(a, b):
        if b == 0.0:
            return float("nan") if a == 0.0 else float("inf")
        return a / b

    print(f"MinHash search time (s): {st['minhash_search_time']}",
          file=sys.stderr)
    print(f"Total matches found: {st['matches_processed']}",
          file=sys.stderr)
    print("Average number of matches per lookup: "
          f"{jdiv(matches, searched)}", file=sys.stderr)
    print("Average number of table elements processed per lookup: "
          f"{jdiv(st['elements_processed'], searched)}", file=sys.stderr)
    print("Average number of table elements processed per match: "
          f"{jdiv(st['elements_processed'], matches)}", file=sys.stderr)
    print("Average % of hashed sequences hit per lookup: "
          f"{jdiv(hit, size * searched) * 100.0}", file=sys.stderr)
    print("Average % of hashed sequences hit that are matches: "
          f"{jdiv(matches, hit) * 100.0}", file=sys.stderr)
    print("Average % of hashed sequences fully compared that are "
          f"matches: {jdiv(matches, compared) * 100.0}", file=sys.stderr)


def run_oracle(o) -> None:
    """--backend oracle: the self/query loop of mhap_tpu.cli.main.
    run_overlap (:331-450) on the numpy reference pipeline, with its
    refusals of ``.dat`` input and ``-p``."""
    from ..oracle import pipeline as oracle

    if o.get("-p").value:
        if not os.path.isdir(o.get("-q").value):
            raise SystemExit("Target directory doesn't exit.")
        raise SystemExit("-p requires the device backend")
    s_file, q_file = o.get("-s").value, o.get("-q").value
    q_files = list_sequence_files(q_file) if q_file else []
    if any(f.endswith(".dat") for f in [s_file, *q_files]):
        raise SystemExit(".dat input requires the device backend")
    cfg = options_to_cfg(o)
    kmer_filter = load_filter(o, oracle=True)
    store_full_id = o.get("--store-full-id").value
    no_self, paf = o.get("--no-self").value, o.get("--paf").value
    t0 = time.time()
    print("Processing files for storage in reverse index...",
          file=sys.stderr)
    headers, reads = _load_reads(s_file, store_full_id)
    box = oracle.sketch_all(reads, cfg, kmer_filter, headers,
                            do_rc=not o.get("--no-rc").value)
    print(f"Processed {len(box)} unique sequences (fwd and rev).",
          file=sys.stderr)
    print(f"Time (s) to read and hash from file: {time.time() - t0}",
          file=sys.stderr)
    index = oracle.OracleIndex(cfg)
    for sk in box:
        index.add(sk)
    out = sys.stdout
    n_lines = 0
    if not no_self or not q_file:
        lines = [line for sk in box if sk.is_fwd
                 for line in index.find_matches(sk, to_self=True)]
        n_lines += write_lines(sorted(lines), out, paf)
    offset = len(box) // 2
    for qf in q_files:
        qh, qreads = _load_reads(qf, store_full_id)
        queries = oracle.sketch_all(qreads, cfg, kmer_filter, qh,
                                    offset=offset, do_rc=False)
        lines = [line for sk in queries
                 for line in index.find_matches(sk, to_self=False)]
        n_lines += write_lines(sorted(lines), out, paf)
        offset += len(queries)
    out.flush()
    print(f"Total matches found: {n_lines}", file=sys.stderr)


def run_precompute(o, ov) -> None:
    """-p: each file of the -p argument sketched into <name>.dat in the
    -q directory (mhap_tpu.cli.main.run_precompute, :453-483)."""
    to_dir = o.get("-q").value
    if not os.path.isdir(to_dir):
        raise SystemExit("Target directory doesn't exit.")
    print("Processing FASTA files for binary compression...",
          file=sys.stderr)
    store_full_id = o.get("--store-full-id").value
    for pf in list_sequence_files(o.get("-p").value):
        t0 = time.time()
        headers, reads = _load_reads(pf, store_full_id)
        store = ov.sketch_reads(reads, headers,
                                do_rc=not o.get("--no-rc").value)
        name = os.path.basename(pf)
        i = name.rfind(".")
        if i > 0:
            name = name[:i]
        out_path = os.path.join(to_dir, name + ".dat")
        whole = ov.whole_store(store)
        if whole is not None:  # None on a rank other than 0
            with trace.span("dat.write"):
                written = datstore.write_dat(
                    out_path, whole,
                    ordered_kmer_size=ov.cfg["ordered_kmer_size"])
            trace.count("dat_records_written", written)
        print(f"Processed {len(store)} sequences (fwd and rev).",
              file=sys.stderr)
        print(f"Read, hashed, and stored file {pf} to {out_path}.",
              file=sys.stderr)
        print(f"Time (s): {time.time() - t0}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
