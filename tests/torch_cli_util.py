"""Running the JAX CLI and the port's CLI on the same arguments, in
process, for the port's CLI tests.

The JAX CLI builds a new ``TpuOverlapper`` for every run, and each one
compiles its programs anew (some ten seconds on the CPU).
``jax_cli_main`` hands the runs of one sketch size and max shift a single
strict overlapper instead (no deferred sketch flags, a 32-row sketch tile,
64-pair scorer chunks), swapping in the run's k-mer filter, so that its
compiled programs carry over.  Its printed lines do not depend on that:
only the stats on stderr accumulate.  The port's CLI runs on a CPU
overlapper (``main(argv, device="cpu")``)."""

import os

from mhap_tpu.cli import main as jax_cli
from mhap_tpu.pipeline.freqfilter import VectorFrequencyFilter
from mhap_tpu_torch.cli.main import main as port_cli

_overlappers: dict = {}
_get_overlapper = jax_cli._get_overlapper


def _shared_overlapper(cfg, backend, kmer_filter, num_threads=None):
    # an overlapper fixes only its scorer's program (max_shift, S) at
    # construction; the rest of cfg is read at each call.  The oracle
    # backend has none.
    if backend not in ("device", "sharded"):
        return None
    key = (cfg["ordered_sketch_size"], cfg["max_shift"])
    if key not in _overlappers:
        ov = _get_overlapper(cfg, backend, None, num_threads)
        ov._defer_flags = False
        ov.ROWS = 32
        ov.pair_chunk = 64
        _overlappers[key] = ov
    ov = _overlappers[key]
    ov.cfg.update(cfg)
    ov.kmer_filter = (None if kmer_filter is None
                      else VectorFrequencyFilter(kmer_filter))
    ov._filt_dev = "unset"
    return ov


def jax_cli_main(argv):
    try:
        jax_cli._get_overlapper = _shared_overlapper
        return jax_cli.main(argv)
    finally:
        jax_cli._get_overlapper = _get_overlapper


def port_cli_main(argv):
    return port_cli(argv, device="cpu")


def run(cli, argv, capsys, err=False):
    """stdout lines of one CLI run, which must exit 0 (and its stderr
    when ``err``)."""
    rc = cli(argv)
    out = capsys.readouterr()
    assert rc == 0, out.err
    return (out.out.splitlines(), out.err) if err else out.out.splitlines()


def both(argv_of, tmp_path, capsys):
    """stdout of the JAX CLI and of the port's, each given a directory
    of its own (``tmp_path/jax``, ``tmp_path/port``) by ``argv_of``."""
    out = []
    for name, cli in (("jax", jax_cli_main), ("port", port_cli_main)):
        d = tmp_path / name
        os.makedirs(d, exist_ok=True)
        out.append(run(cli, argv_of(d), capsys))
    return out
