"""FASTA output: copy of ``sam2consensus_tpu/io/fasta.py``.

File naming, record joining, optional wrapping and the per-file messages
follow the reference (``sam2consensus.py:411-424``), so output directories
compare byte-identical.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List


@dataclass
class FastaRecord:
    header: str   # full ">..." header line
    seq: str      # unwrapped sequence text


def render_file(records: List[FastaRecord], nchar: int) -> str:
    """Join one reference's records; wrap every ``nchar`` if nonzero."""
    if nchar == 0:
        body = "\n".join(r.header + "\n" + r.seq for r in records)
    else:
        body = "\n".join(
            r.header + "\n" + "\n".join(r.seq[s:s + nchar]
                                        for s in range(0, len(r.seq), nchar))
            for r in records)
    return body + "\n"


def write_outputs(fastas: Dict[str, List[FastaRecord]], outfolder: str,
                  prefix: str, nchar: int, thresholds: List[float],
                  echo=print) -> List[str]:
    """One ``{ref}__{prefix}.fasta`` per reference; returns paths written."""
    paths = []
    for reference, records in fastas.items():
        outnameprefix = reference + "__" + prefix
        path = outfolder + outnameprefix + ".fasta"
        with open(path, "w") as fh:
            fh.write(render_file(records, nchar))
        paths.append(path)
        pcts = [str(int(t * 100)) + "%" for t in thresholds]
        if len(thresholds) == 1:
            echo("Consensus sequence at " + pcts[0] + " saved for "
                 + reference + " in: " + path)
        else:
            echo("Consensus sequences at " + ",".join(pcts) + " saved for "
                 + reference + " in: " + path)
    return paths
