"""Domain constants: mutation-type vocabularies and standard color maps.

Copied from salamander_tpu/consts.py: feature-parity with the reference's
consts.py (SBS_TYPES_96 :3-9, INDEL_TYPES_83 :12-37, color palettes
:40-88). The vocabularies are the
standard COSMIC SBS-96 / ID-83 channel definitions; the indel list is built
programmatically here from its (kind, unit, size, length-counts) structure.
Beyond the reference, the full COSMIC catalog family is covered: DBS-78
doublet substitutions, CN-48 copy-number segments and SV-32 structural
variants, each with a grouped spectrum-plot palette.
"""

from __future__ import annotations

NUCLEOTIDES = ["A", "C", "G", "T"]

SBS_TYPES_6 = ["C>A", "C>G", "C>T", "T>A", "T>C", "T>G"]

# 96 trinucleotide-context single-base substitution channels,
# ordered by substitution class, then 5' base, then 3' base.
SBS_TYPES_96 = [
    f"{five}[{sub}]{three}"
    for sub in SBS_TYPES_6
    for five in NUCLEOTIDES
    for three in NUCLEOTIDES
]


def _indel_block(kind: str, unit: str, lengths: list[str]) -> list[str]:
    return [f"{kind}.{unit}.{length}" for length in lengths]


def _build_indel_types_83() -> list[str]:
    """The standard 83-channel COSMIC indel classification."""
    del_sizes = ["1", "2", "3", "4", "5", "6+"]  # deletion homopolymer/repeat sizes
    ins_sizes = ["0", "1", "2", "3", "4", "5+"]  # insertion repeat sizes
    types: list[str] = []
    # 1bp deletions / insertions in C and T homopolymers
    for base in ["C", "T"]:
        types += _indel_block("DEL", base, [f"1.{s}" for s in del_sizes])
    for base in ["C", "T"]:
        types += _indel_block("INS", base, [f"1.{s}" for s in ins_sizes])
    # >=2bp deletions / insertions at repeats
    for rep in ["2", "3", "4", "5+"]:
        types += _indel_block("DEL", "repeats", [f"{rep}.{s}" for s in del_sizes])
    for rep in ["2", "3", "4", "5+"]:
        types += _indel_block("INS", "repeats", [f"{rep}.{s}" for s in ins_sizes])
    # deletions at microhomologies: homology length <= deletion length - 1
    mh_lengths = {"2": ["1"], "3": ["1", "2"], "4": ["1", "2", "3"],
                  "5+": ["1", "2", "3", "4", "5+"]}
    for size, homologies in mh_lengths.items():
        types += _indel_block("DEL", "MH", [f"{size}.{h}" for h in homologies])
    return types


INDEL_TYPES_83 = _build_indel_types_83()
assert len(INDEL_TYPES_83) == 83

# The 10 canonical COSMIC DBS-78 reference doublets with their alternate
# alleles (reverse-complement-collapsed: AT/CG/GC/TA are their own reverse
# complements and keep 6 alternates, the other six doublets keep 9).
# Beyond the reference (its consts stop at SBS96/ID83); channel order is the
# standard COSMIC v3 DBS78 catalog order.
_DBS_ALTS = {
    "AC": ["CA", "CG", "CT", "GA", "GG", "GT", "TA", "TG", "TT"],
    "AT": ["CA", "CC", "CG", "GA", "GC", "TA"],
    "CC": ["AA", "AG", "AT", "GA", "GG", "GT", "TA", "TG", "TT"],
    "CG": ["AT", "GC", "GT", "TA", "TC", "TT"],
    "CT": ["AA", "AC", "AG", "GA", "GC", "GG", "TA", "TC", "TG"],
    "GC": ["AA", "AG", "AT", "CA", "CG", "TA"],
    "TA": ["AT", "CG", "CT", "GC", "GG", "GT"],
    "TC": ["AA", "AG", "AT", "CA", "CG", "CT", "GA", "GG", "GT"],
    "TG": ["AA", "AC", "AT", "CA", "CC", "CT", "GA", "GC", "GT"],
    "TT": ["AA", "AC", "AG", "CA", "CC", "CG", "GA", "GC", "GG"],
}

DBS_TYPES_78 = [
    f"{ref}>{alt}" for ref, alts in _DBS_ALTS.items() for alt in alts
]
assert len(DBS_TYPES_78) == 78

# A 10-color qualitative palette (Mathematica default colors).
COLORS_MATHEMATICA = [
    (0.368417, 0.506779, 0.709798),
    (0.880722, 0.611041, 0.142051),
    (0.560181, 0.691569, 0.194885),
    (0.922526, 0.385626, 0.209179),
    (0.528288, 0.470624, 0.701351),
    (0.772079, 0.431554, 0.102387),
    (0.363898, 0.618501, 0.782349),
    (1.0, 0.75, 0.0),
    (0.280264, 0.715, 0.429209),
    (0.0, 0.0, 0.0),
]

# The six standard substitution-class colors of the SBS-96 spectrum plots.
COLORS_TRINUCLEOTIDES = [
    (0.33, 0.75, 0.98),  # C>A light blue
    (0.0, 0.0, 0.0),     # C>G black
    (0.85, 0.25, 0.22),  # C>T red
    (0.78, 0.78, 0.78),  # T>A grey
    (0.51, 0.79, 0.24),  # T>C green
    (0.89, 0.67, 0.72),  # T>G pink
]

COLORS_SBS96 = [COLORS_TRINUCLEOTIDES[i // 16] for i in range(96)]

# Standard COSMIC ID-83 group colors (one per 16 indel groups).
COLORS_INDEL = [
    "#FCBD6F",  # 1bp Del C
    "#FD8001",  # 1bp Del T
    "#B0DC8B",  # 1bp Ins C
    "#35A02E",  # 1bp Ins T
    "#FCC9B4",  # 2bp Del Repeats
    "#FC896B",  # 3bp Del Repeats
    "#F04432",  # 4bp Del Repeats
    "#BC1A1A",  # 5+ bp Del Repeats
    "#CFE0F0",  # 2bp Ins Repeats
    "#94C3DF",  # 3bp Ins Repeats
    "#4A98C8",  # 4bp Ins Repeats
    "#1665AA",  # 5+ bp Ins Repeats
    "#E1E0ED",  # 2bp Del MH
    "#B5B5D8",  # 3bp Del MH
    "#8683BC",  # 4bp Del MH
    "#624099",  # 5+bp Del MH
]

_GROUP_SIZES = 12 * [6] + [1, 2, 3, 5]
COLORS_INDEL83 = [
    color for size, color in zip(_GROUP_SIZES, COLORS_INDEL) for _ in range(size)
]
assert len(COLORS_INDEL83) == 83

# Standard DBS-78 group colors (one per reference doublet, the
# SigProfiler/COSMIC spectrum-plot convention).
COLORS_DBS = [
    "#03BDEF",  # AC>NN light blue
    "#0266CC",  # AT>NN blue
    "#A5CF63",  # CC>NN light green
    "#016601",  # CG>NN dark green
    "#FE9898",  # CT>NN light red
    "#E42A25",  # GC>NN red
    "#FEB064",  # TA>NN light orange
    "#FD8004",  # TC>NN orange
    "#CB98FD",  # TG>NN light purple
    "#4C0299",  # TT>NN purple
]

COLORS_DBS78 = [
    color
    for alts, color in zip(_DBS_ALTS.values(), COLORS_DBS)
    for _ in range(len(alts))
]
assert len(COLORS_DBS78) == 78

# COSMIC CN-48 copy-number channels (Steele et al. 2022): total-copy-number
# class x heterozygosity state x segment-length bin. Homozygous deletions use
# three coarse length bins; every other (class, zygosity) group uses five.
# Beyond the reference (its consts stop at SBS96/ID83).
_CN_SIZES_HOMDEL = ["0-100kb", "100kb-1Mb", ">1Mb"]
_CN_SIZES = ["0-100kb", "100kb-1Mb", "1Mb-10Mb", "10Mb-40Mb", ">40Mb"]
_CN_GROUPS = (
    [("0", "homdel", _CN_SIZES_HOMDEL)]
    + [(cn, "LOH", _CN_SIZES) for cn in ["1", "2", "3-4", "5-8", "9+"]]
    + [(cn, "het", _CN_SIZES) for cn in ["2", "3-4", "5-8", "9+"]]
)

CN_TYPES_48 = [
    f"{cn}:{zygosity}:{size}"
    for cn, zygosity, sizes in _CN_GROUPS
    for size in sizes
]
assert len(CN_TYPES_48) == 48

# CN-48 group colors: one per (total copy number, zygosity) group, deletion
# classes in blues (darkest = homozygous deletion), LOH classes warm
# (amber -> dark red with rising copy number), het classes in greens/purples.
COLORS_CN = [
    "#08306B",  # 0 homdel  dark navy
    "#2171B5",  # 1 LOH     blue
    "#FDD49E",  # 2 LOH     pale amber
    "#FDBB84",  # 3-4 LOH   amber
    "#EF6548",  # 5-8 LOH   orange-red
    "#990000",  # 9+ LOH    dark red
    "#C7E9C0",  # 2 het     pale green
    "#74C476",  # 3-4 het   green
    "#238B45",  # 5-8 het   dark green
    "#6A51A3",  # 9+ het    purple
]

COLORS_CN48 = [
    color
    for (_, _, sizes), color in zip(_CN_GROUPS, COLORS_CN)
    for _ in range(len(sizes))
]
assert len(COLORS_CN48) == 48

# COSMIC SV-32 structural-variant channels: clustered / non-clustered x
# {deletion, tandem duplication, inversion, translocation}, with five length
# bins for the length-bearing classes (translocations carry no length).
# Beyond the reference.
_SV_SIZES = ["1-10Kb", "10-100Kb", "100Kb-1Mb", "1Mb-10Mb", ">10Mb"]
_SV_GROUPS = [
    (cluster, svtype)
    for cluster in ["clustered", "non-clustered"]
    for svtype in ["del", "tds", "inv", "trans"]
]

SV_TYPES_32 = [
    name
    for cluster, svtype in _SV_GROUPS
    for name in (
        [f"{cluster}_{svtype}"]
        if svtype == "trans"
        else [f"{cluster}_{svtype}_{size}" for size in _SV_SIZES]
    )
]
assert len(SV_TYPES_32) == 32

# SV-32 group colors: one per (cluster status, SV class) group; the
# clustered half uses saturated hues, the non-clustered half lighter tints.
COLORS_SV = [
    "#C82828",  # clustered del
    "#5AA02C",  # clustered tds
    "#2C66A0",  # clustered inv
    "#7B4FA0",  # clustered trans
    "#E89A9A",  # non-clustered del
    "#B4D98E",  # non-clustered tds
    "#94B8DC",  # non-clustered inv
    "#C4A8DC",  # non-clustered trans
]

COLORS_SV32 = [
    color
    for (_, svtype), color in zip(_SV_GROUPS, COLORS_SV)
    for _ in range(1 if svtype == "trans" else len(_SV_SIZES))
]
assert len(COLORS_SV32) == 32
