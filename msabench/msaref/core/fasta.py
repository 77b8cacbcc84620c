# Frozen copy of mlprobs_tpu_torch/core/fasta.py at commit 30598a0 (the
# benchmark's plain reference: PyTorch and NumPy only, no CUDA kernel
# and no C++ helper; see msabench/msaref/__init__.py).
"""FASTA reading/writing.

Matches the reference I/O contract: multi-line records are concatenated
(script.py Preprocessing / MultiSequence::LoadMFA), output is wrapped at 60
columns (MultiSequence::WriteMFA default), and the MLProbs Python stages
write 2-line records sorted by header (do_realign.py / seperate_regions.py).
"""
from __future__ import annotations

import io
from pathlib import Path


def parse_fasta(text: str) -> list[tuple[str, str]]:
    """Parse FASTA text into (header, sequence) pairs in file order.

    Headers keep everything after '>' up to end of line; sequence lines are
    concatenated with whitespace/CR stripped.  Files whose first record
    does not start with '>' fall through to the MSF/ClustalW interleaved
    parser, mirroring MultiSequence::LoadMFA -> ParseMSF
    (MultiSequence.h:267-295, :121-240).
    """
    for line in text.splitlines():
        if line.strip():
            if not line.lstrip().startswith(">"):
                return parse_msf(text)
            break
    records: list[tuple[str, list[str]]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            records.append((line[1:], []))
        elif records:
            records[-1][1].append(line)
    return [(h, "".join(parts)) for h, parts in records]


def _msf_chars(chunk: str) -> str:
    """Normalise one MSF/ClustalW residue chunk the reference way:
    lowercase -> uppercase, '.' -> '-'; reject anything else."""
    out = []
    for ch in chunk:
        if ch.isspace():
            continue
        if "a" <= ch <= "z":
            ch = ch.upper()
        if ch == ".":
            ch = "-"
        if not (("A" <= ch <= "Z") or ch in "*-"):
            raise ValueError(f"Unknown character encountered: {ch}")
        out.append(ch)
    return "".join(out)


def parse_msf(text: str) -> list[tuple[str, str]]:
    """GCG MSF / ClustalW interleaved alignments (ParseMSF,
    MultiSequence.h:121-240): CLUSTAL/MSAPROBS headers switch to
    on-the-fly name discovery; MSF declares names via 'Name:' lines
    after a '..' header; a '//' separator with no header also enables
    name discovery."""
    lines = text.splitlines()
    pos = 0
    clustalw = False
    missing_header = False
    # read until data starts
    while pos < len(lines):
        header = lines[pos]
        if header.startswith("CLUSTAL") or header.startswith("MSAPROBS"):
            clustalw = True
            pos += 1
            break
        if ".." in header:
            pos += 1
            break
        if "//" in header:
            missing_header = True
            pos += 1
            break
        pos += 1
    names: list[str] = []
    data: dict[str, list[str]] = {}
    for line in lines[pos:]:
        parts = line.split()
        if not parts:
            continue
        word = parts[0]
        if clustalw and not line[0].isspace() and word not in names:
            names.append(word)
            data[word] = []
        if word == "Name:":
            if len(parts) < 2:
                break
            names.append(parts[1])
            data[parts[1]] = []
        elif word in data:
            data[word].append(_msf_chars("".join(parts[1:])))
        elif missing_header:
            names.append(word)
            data[word] = [_msf_chars("".join(parts[1:]))]
    return [(n, "".join(data[n])) for n in names]


def read_fasta(path: str | Path) -> list[tuple[str, str]]:
    return parse_fasta(Path(path).read_text())


def format_fasta(
    records: list[tuple[str, str]], width: int = 60
) -> str:
    """Format records as FASTA; width<=0 disables wrapping."""
    buf = io.StringIO()
    for header, seq in records:
        buf.write(f">{header}\n")
        if width and width > 0:
            for i in range(0, len(seq), width):
                buf.write(seq[i : i + width])
                buf.write("\n")
            if not seq:
                buf.write("\n")
        else:
            buf.write(seq)
            buf.write("\n")
    return buf.getvalue()


def write_fasta(
    path: str | Path, records: list[tuple[str, str]], width: int = 60
) -> None:
    Path(path).write_text(format_fasta(records, width=width))
