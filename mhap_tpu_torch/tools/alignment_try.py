"""Dev scratch exercising the aligner + windowed sub-sketches (the port's
copy of mhap_tpu/tools/alignment_try.py).

Parity target: main/AlignmentTry.java (a manual smoke main over
RandomSequenceGenerator input, the Aligner, and the experimental
MinHashBitSequenceSubSketches).  Deterministic via the bit-exact
MersenneTwisterFast port.
"""

from __future__ import annotations

import sys

from ..align.aligner import Aligner, AlignElementString
from ..align.elements import MinHashBitSequenceSubSketches
from ..utils.seqgen import RandomSequenceGenerator


def main(argv=None) -> int:
    gen = RandomSequenceGenerator(0)
    base = gen.generate_random_sequence(3000)
    a = gen.add_pacbio_error(base[:2200])
    b = gen.add_pacbio_error(base[800:3000])

    al = Aligner(True, -2.0, -0.5, 0.0)
    res = al.local_align_smith_water_gotoh(
        AlignElementString(a[:400]), AlignElementString(b[:400]))
    print(f"string SW: score={res.score:.1f} a=[{res.a1},{res.a2}] "
          f"b=[{res.b1},{res.b2}] ops={len(res.operations or [])}")

    sk_a = MinHashBitSequenceSubSketches(a, 12, 200, 8)
    sk_b = MinHashBitSequenceSubSketches(b, 12, 200, 8)
    chain = Aligner(True, -0.52, 0.0, -0.48)
    score, raw, a1, a2, b1, b2 = sk_a.get_overlap_info(chain, sk_b)
    print(f"subsketch overlap: score={score:.4f} raw={raw:.1f} "
          f"a=[{a1},{a2}] b=[{b1},{b2}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
