"""The one traffic generator: a configuration plus a traffic mix -> a pool
of distinct samples, each a set of aligned Illumina read pairs.

Everything is drawn from a seed with NumPy in whole-array steps: the
genome from the configuration's own seed (every run shares the
reference), each sample's variants, fragments, bases, sequencing errors
and binned qualities from ``(seed, sample index)``.  A sample is a
:class:`Sample`: the SAM fields the consensus reads (POS, CIGAR, SEQ) plus
the ones a real record carries (names, flags, mates, qualities, tags),
which :mod:`.sam` writes out.  The reference consensus
reads the same :class:`Sample` (``reference/consensus.py``).

Two library kinds:

* ``amplicon``: tiled amplicons with log-normal yields and a few dropped
  per sample; a share of the fragments is a whole amplicon whose primer
  bases are soft-clipped on both reads (as ``ivar trim`` leaves them), the
  rest are tagmented pieces inside one amplicon;
* ``shotgun``: uniform fragments with a normal insert size; a share of
  the reads is soft-clipped at its 3' end, as ``bwa mem`` clips adapter
  read-through.

A read's aligned part maps through the sample's haplotype back to the
reference: where it crosses a variant indel or carries a sequencing indel
error, its CIGAR gets the ``I``/``D``; an insertion at either end of the
aligned part becomes a soft clip, as an aligner would write it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
#: NovaSeq RTA3 quality bins (Q2, Q12, Q23, Q37) as SAM characters
QUAL_BINS = np.frombuffer(b"#-8F", dtype=np.uint8)


@dataclasses.dataclass
class Sample:
    """One sample's aligned reads, in the order they are written."""

    name: str
    contig: str
    contig_len: int
    pos: np.ndarray          # int64, 0-based leftmost aligned position
    cigars: List[str]        # the distinct CIGARs
    cigar_id: np.ndarray     # int64, each read's index into ``cigars``
    seq: np.ndarray          # uint8 [n, read_len], ASCII ACGTN
    qual: np.ndarray         # uint8 [n, read_len], ASCII phred+33
    flag: np.ndarray         # int64
    mate_pos: np.ndarray     # int64, 0-based
    tlen: np.ndarray         # int64
    nm: np.ndarray           # int64, edit distance tag
    tile: np.ndarray         # int64, read-name fields
    x: np.ndarray
    y: np.ndarray

    @property
    def n_reads(self) -> int:
        return int(self.pos.shape[0])


def _rng(*key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(k) & 0xFFFFFFFFFFFFFFFF for k in key]))


def genome(cfg: dict) -> np.ndarray:
    """The configuration's reference sequence: ASCII ACGT at its GC share,
    from its own seed (the same in every run)."""
    g = cfg["genome"]
    rng = _rng(g["seed"])
    u = rng.random(g["length"], dtype=np.float32)
    gc = g["gc"]
    # A, C, G, T with P(C) = P(G) = gc / 2
    edges = np.array([(1 - gc) / 2, 0.5, 0.5 + gc / 2], dtype=np.float32)
    return BASES[np.searchsorted(edges, u, side="right")]


def _variant_sites(rng, n_sites: int, length: int, margin: int,
                   spacing: int, allowed=None) -> np.ndarray:
    """``n_sites`` positions at least ``spacing`` apart, ``margin`` from
    the contig's ends (and inside ``allowed`` windows when given)."""
    picked: List[int] = []
    for _ in range(200 * max(1, n_sites)):
        if len(picked) == n_sites:
            break
        if allowed is not None:
            lo, hi = allowed[rng.integers(len(allowed))]
            p = int(rng.integers(lo, hi))
        else:
            p = int(rng.integers(margin, length - margin))
        if all(abs(p - q) >= spacing for q in picked):
            picked.append(p)
    return np.array(sorted(picked), dtype=np.int64)


def haplotype(ref: np.ndarray, cfg: dict, rng, allowed=None):
    """The sample's haplotype: (bases, reference coordinate of each base
    or -1 for an inserted one, reference -> haplotype index or -1)."""
    v = cfg["variants"]
    L = ref.shape[0]
    dels = list(v.get("deletions", ()))
    inss = list(v.get("insertions", ()))
    n_indel = len(dels) + len(inss)
    sites = _variant_sites(rng, n_indel, L, 500, v["indel_spacing"], allowed)
    rng.shuffle(sites)
    del_at = dict(zip(sites[:len(dels)].tolist(), dels))
    ins_at = dict(zip(sites[len(dels):].tolist(), inss))
    if "snps" in v:
        n_snp = int(v["snps"])
    else:
        n_snp = int(rng.poisson(L * v["snps_per_kbp"] / 1000.0))
    snp = np.unique(rng.integers(0, L, n_snp))
    near = np.zeros(L, dtype=bool)
    for s in sites.tolist():
        near[max(0, s - 12):s + 20] = True
    snp = snp[~near[snp]]
    sample_ref = ref.copy()
    shift = rng.integers(1, 4, snp.shape[0])
    code = np.searchsorted(BASES, ref[snp])
    sample_ref[snp] = BASES[(code + shift) % 4]

    seq_parts, ref_parts = [], []
    cur = 0
    for s in sorted(set(del_at) | set(ins_at)):
        seq_parts.append(sample_ref[cur:s])
        ref_parts.append(np.arange(cur, s, dtype=np.int64))
        if s in ins_at:
            motif = BASES[rng.integers(0, 4, ins_at[s])]
            seq_parts.append(motif)
            ref_parts.append(np.full(motif.shape[0], -1, dtype=np.int64))
            cur = s
        else:
            cur = s + del_at[s]
    seq_parts.append(sample_ref[cur:])
    ref_parts.append(np.arange(cur, L, dtype=np.int64))
    hap = np.concatenate(seq_parts)
    hap_ref = np.concatenate(ref_parts)
    ref2hap = np.full(L, -1, dtype=np.int64)
    real = hap_ref >= 0
    ref2hap[hap_ref[real]] = np.nonzero(real)[0]
    return hap, hap_ref, ref2hap


def amplicon_windows(cfg: dict) -> np.ndarray:
    """``[n, 2]`` reference intervals of the scheme's amplicons: an even
    tiling from the first start to the last end."""
    lib = cfg["library"]
    n = lib["amplicons"]
    alen = lib["amplicon_length"]
    starts = np.round(np.linspace(lib["first_start"],
                                  lib["last_end"] - alen, n)).astype(np.int64)
    return np.stack([starts, starts + alen], axis=1)


def _fragments_amplicon(cfg, rng, ref2hap, n_frag):
    """Per fragment: haplotype start, end, and primer clip on each end."""
    lib = cfg["library"]
    amp = amplicon_windows(cfg)
    n_amp = amp.shape[0]
    primer = lib["primer_length"]
    w = rng.lognormal(0.0, lib["yield_sigma"], n_amp)
    n_drop = int(rng.integers(0, lib["dropped_amplicons_max"] + 1))
    if n_drop:
        w[rng.choice(n_amp, n_drop, replace=False)] = 0.0
    per_amp = rng.multinomial(n_frag, w / w.sum())
    k = np.repeat(np.arange(n_amp), per_amp)
    a = ref2hap[amp[k, 0]]
    b = ref2hap[amp[k, 1] - 1] + 1
    whole = rng.random(n_frag) < lib["end_anchored_share"]
    span = b - a
    inner_lo = a + primer
    inner_hi = b - primer
    flen = rng.integers(lib["fragment_min"], (inner_hi - inner_lo) + 1)
    start = inner_lo + (rng.random(n_frag) * (inner_hi - inner_lo - flen + 1)
                        ).astype(np.int64)
    fs = np.where(whole, a, start)
    fe = np.where(whole, a + span, start + flen)
    clip = np.where(whole, primer, 0)
    return fs, fe, clip


def _fragments_shotgun(cfg, rng, hap_len, n_frag):
    lib = cfg["library"]
    rl = cfg["reads"]["length"]
    flen = np.clip(np.round(rng.normal(lib["insert_mean"], lib["insert_sd"],
                                       n_frag)), rl + 10, 4 * rl)
    flen = flen.astype(np.int64)
    fs = (rng.random(n_frag) * (hap_len - flen)).astype(np.int64)
    return fs, fs + flen, np.zeros(n_frag, dtype=np.int64)


def _cigar_of(refc: np.ndarray, clip_l: int, clip_r: int):
    """(0-based pos, CIGAR) of a read whose aligned bases have the
    reference coordinates ``refc`` (-1 = inserted base)."""
    lead = 0
    while lead < refc.shape[0] and refc[lead] < 0:
        lead += 1
    trail = 0
    while trail < refc.shape[0] - lead and refc[-1 - trail] < 0:
        trail += 1
    core = refc[lead:refc.shape[0] - trail]
    clip_l += lead
    clip_r += trail
    ops: List[list] = []

    def add(op, n):
        if ops and ops[-1][1] == op:
            ops[-1][0] += n
        else:
            ops.append([n, op])

    prev = -1
    for c in core.tolist():
        if c < 0:
            add("I", 1)
            continue
        if prev >= 0 and c > prev + 1:
            add("D", c - prev - 1)
        add("M", 1)
        prev = c
    text = (f"{clip_l}S" if clip_l else "") + "".join(
        f"{n}{op}" for n, op in ops) + (f"{clip_r}S" if clip_r else "")
    return int(core[0]), text


#: reads a step of the error model handles at once (bounds its memory)
CHUNK_READS = 131072
_CODE = np.zeros(256, dtype=np.uint8)
_CODE[BASES] = np.arange(4, dtype=np.uint8)


def _mix(seq, start, hap, ref2hap, v, rng) -> None:
    """Minor variants: at ``mixed_sites`` reference positions a share of
    the sample's molecules (drawn from ``mixed_af``) carries another base,
    as a mixed infection or a within-host variant does."""
    n_sites = int(v.get("mixed_sites", 0))
    if not n_sites:
        return
    lo, hi = v["mixed_af"]
    rl = seq.shape[1]
    for m in rng.integers(0, ref2hap.shape[0], n_sites).tolist():
        h = int(ref2hap[m])
        if h < 0:
            continue
        col = h - start
        rows = np.nonzero((col >= 0) & (col < rl))[0]
        af = rng.uniform(lo, hi)
        alt = BASES[(_CODE[hap[h]] + rng.integers(1, 4)) % 4]
        rows = rows[rng.random(rows.shape[0]) < af]
        seq[rows, col[rows]] = alt


def _uniform16(rng, shape) -> np.ndarray:
    """Uniform integers 0..65535: one random byte pair per entry."""
    n = int(np.prod(shape))
    return np.frombuffer(rng.bytes(2 * n), dtype=np.uint16).reshape(shape)


def _sequence(seq, qual, reverse, clip_l, clip_r, adapter, e, rng):
    """Sequencing in place over a block of reads: adapter bases under a
    shotgun clip, substitutions ramping from the read's 5' end, a few Ns,
    and qualities in the instrument's bins.  Returns each read's
    substitutions and Ns (its ``NM`` tag before indels)."""
    n, rl = seq.shape
    cols = np.arange(rl)
    if adapter:
        clipped = ((cols[None, :] < clip_l[:, None])
                   | (cols[None, :] >= rl - clip_r[:, None]))
        seq[clipped] = BASES[rng.integers(0, 4, int(clipped.sum()))]
    ramp = np.linspace(e["substitution_start"], e["substitution_end"], rl)
    t_sub = np.round(ramp * 65536).astype(np.uint16)
    t_n = np.round((ramp + e["n_rate"]) * 65536).astype(np.uint16)
    u = _uniform16(rng, seq.shape)
    fwd = ~reverse
    sub = np.empty(seq.shape, dtype=bool)
    isn = np.empty(seq.shape, dtype=bool)
    sub[fwd] = u[fwd] < t_sub
    sub[reverse] = u[reverse] < t_sub[::-1]
    isn[fwd] = u[fwd] < t_n
    isn[reverse] = u[reverse] < t_n[::-1]
    isn &= ~sub
    k = int(sub.sum())
    seq[sub] = BASES[(_CODE[seq[sub]] + rng.integers(1, 4, k)) % 4]
    seq[isn] = ord("N")
    uq = _uniform16(rng, seq.shape)
    lvl = np.zeros(seq.shape, dtype=np.uint8)
    for c in e["quality_good_cdf"]:
        lvl += uq >= np.uint16(round(c * 65536))
    qual[...] = QUAL_BINS[3 - lvl]
    if k:
        ub = uq[sub]
        bad = sum((ub >= np.uint16(round(c * 65536))).astype(np.uint8)
                  for c in e["quality_error_cdf"])
        qual[sub] = QUAL_BINS[bad]
    qual[isn] = QUAL_BINS[0]
    return sub.sum(1) + isn.sum(1)

def sample(cfg: dict, traffic: dict, seed: int, index: int,
           ref: Optional[np.ndarray] = None) -> Sample:
    """Sample ``index`` of the pool drawn from ``seed``."""
    if ref is None:
        ref = genome(cfg)
    rng = _rng(seed, index, 0x5A)
    rl = cfg["reads"]["length"]
    lib = cfg["library"]
    allowed = None
    if lib["kind"] == "amplicon":
        amp = amplicon_windows(cfg)
        p = lib["primer_length"]
        # variant indels away from the primers and the amplicons' overlaps
        allowed = [(int(s) + p + 120, int(e) - p - 120) for s, e in amp]
    hap, hap_ref, ref2hap = haplotype(ref, cfg, rng, allowed)
    n_frag = int(traffic["reads_per_sample"]) // 2
    if lib["kind"] == "amplicon":
        fs, fe, pclip = _fragments_amplicon(cfg, rng, ref2hap, n_frag)
    else:
        fs, fe, pclip = _fragments_shotgun(cfg, rng, hap.shape[0], n_frag)
    # read 1 forward from the fragment's start, read 2 reverse to its end
    n = 2 * n_frag
    start = np.empty(n, dtype=np.int64)
    start[0::2] = fs
    start[1::2] = fe - rl
    reverse = np.zeros(n, dtype=bool)
    reverse[1::2] = True
    clip_l = np.zeros(n, dtype=np.int64)
    clip_r = np.zeros(n, dtype=np.int64)
    clip_l[0::2] = pclip
    clip_r[1::2] = pclip
    if lib["kind"] == "shotgun":
        # adapter read-through: a soft clip at the read's 3' end
        cl = rng.random(n) < lib["clip_share"]
        k = rng.integers(5, lib["clip_max"] + 1, n)
        clip_r = np.where(cl & ~reverse, k, clip_r)
        clip_l = np.where(cl & reverse, k, clip_l)

    # the read's bases: the haplotype's under its span
    seq = np.lib.stride_tricks.sliding_window_view(hap, rl)[start]
    _mix(seq, start, hap, ref2hap, cfg["variants"], rng)
    e = cfg["errors"]
    nm = np.zeros(n, dtype=np.int64)
    qual = np.empty_like(seq)
    for lo in range(0, n, CHUNK_READS):
        hi = min(n, lo + CHUNK_READS)
        nm[lo:hi] = _sequence(seq[lo:hi], qual[lo:hi], reverse[lo:hi],
                              clip_l[lo:hi], clip_r[lo:hi],
                              lib["kind"] == "shotgun", e, rng)

    # which reads need a per-read CIGAR: a variant indel under the aligned
    # part, or a sequencing indel error
    a0 = start + clip_l
    a1 = start + rl - clip_r                 # exclusive, haplotype coords
    ins_cum = np.concatenate([[0], np.cumsum(hap_ref < 0)])
    has_ins = ins_cum[a1] - ins_cum[a0] > 0
    contiguous = hap_ref[a1 - 1] - hap_ref[a0] == (a1 - a0 - 1)
    slow = has_ins | ~contiguous
    p_indel = e["indel_rate"] * rl
    indel_err = rng.random(n) < p_indel
    indel_err &= start + rl + 4 < hap.shape[0]
    slow |= indel_err

    pos = hap_ref[a0].copy()
    # each read's CIGAR: a template of its clips where nothing else
    # crosses it, its own text otherwise
    key = clip_l * 4096 + clip_r
    ukeys, cigar_id = np.unique(np.where(slow, -1, key), return_inverse=True)
    cigars: List[str] = []
    for kk in ukeys.tolist():
        kl, kr = divmod(kk, 4096)
        cigars.append("" if kk < 0 else ((f"{kl}S" if kl else "")
                                         + f"{rl - kl - kr}M"
                                         + (f"{kr}S" if kr else "")))
    known: Dict[str, int] = {c: i for i, c in enumerate(cigars) if c}
    for i in np.nonzero(slow)[0].tolist():
        cl_, cr_ = int(clip_l[i]), int(clip_r[i])
        s = int(start[i])
        bases = seq[i].copy()
        refc = hap_ref[s + cl_:s + rl - cr_].copy()
        if indel_err[i]:
            j = int(rng.integers(10, rl - cl_ - cr_ - 10))
            if rng.random() < 0.5:
                # one extra base in the read
                extra = BASES[rng.integers(0, 4)]
                mid = cl_ + j
                bases[mid + 1:rl - cr_] = bases[mid:rl - cr_ - 1].copy()
                bases[mid] = extra
                refc = np.concatenate([refc[:j], [-1], refc[j:-1]])
            else:
                # one haplotype base skipped
                h = s + cl_ + j
                tail = hap[h + 1:h + 1 + (rl - cr_ - cl_ - j)]
                bases[cl_ + j:rl - cr_] = tail
                refc = np.concatenate(
                    [refc[:j], hap_ref[h + 1:h + 1 + (rl - cr_ - cl_ - j)]])
            nm[i] += 1
            seq[i] = bases
        p_i, text = _cigar_of(refc, cl_, cr_)
        pos[i] = p_i
        cigar_id[i] = known.setdefault(text, len(cigars))
        if cigar_id[i] == len(cigars):
            cigars.append(text)

    # mates: each read's partner is its neighbour in the pair
    mate = np.arange(n) ^ 1
    mpos = pos[mate]
    span_end = np.maximum(pos, mpos) + rl
    tl = span_end - np.minimum(pos, mpos)
    tlen = np.where(reverse, -tl, tl)
    flag = np.where(reverse, 147, 99)
    # bwa mem writes pairs in the order the fragments were sequenced
    order = rng.permutation(n_frag)
    perm = np.stack([2 * order, 2 * order + 1], axis=1).ravel()
    rtile = rng.integers(1101, 2679, n_frag).repeat(2)
    rx = rng.integers(1000, 32000, n_frag).repeat(2)
    ry = rng.integers(1000, 37000, n_frag).repeat(2)
    return Sample(
        name=f"s{index:03d}", contig=cfg["genome"]["name"],
        contig_len=int(ref.shape[0]), pos=pos[perm], cigars=cigars,
        cigar_id=cigar_id[perm], seq=seq[perm],
        qual=qual[perm], flag=flag[perm], mate_pos=mpos[perm],
        tlen=tlen[perm], nm=nm[perm], tile=rtile, x=rx, y=ry)

