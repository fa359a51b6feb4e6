"""The 900-entry AA-pair -> AA reduction table for sloppy mode (-j).

This is behavioral *data* from the reference (kASA.hpp:671-698, table
_sAminoAcids_aas), required byte-for-byte for index compatibility; the
index into the string is ((first_letter & 31) << 5) | (second_letter & 31),
the value's 5-bit code is char & 31.
"""

# The reference declares the table as int8_t[900] but indexes it with
# ((first & 31) << 5) | (second & 31), which reaches 1023 whenever the
# first letter's code is >= 29 (']', '^', or a custom letter) -- an
# out-of-bounds read past the array (same class of quirk as the
# dtoa_milo kPow10 over-read, host/dtoa.py:115).  In the shipped linux
# binary the bytes that follow in the data segment are 28 bytes of
# zero padding and then the start of the codon table _sAminoAcids_bs;
# byte-identical sloppy indices require reproducing exactly those
# reads.  Extracted from the binary (offset of the 900-byte table + 900):
AAS_OOB_TAIL = bytes(
    [0] * 28
) + b"KNNK^_  TTTT^_  IIIM^_  RSSR^_  ^^^^^_  ______            " \
    b"      QHHQ^_  PPPP^_  LLLL^_  RRRR^_  "

AAS_TABLE = (
    '@@@@@@@@@@@@@@@@@@@@@@@@@@@@@@@@@G\\[PIL[]BDMXTXZZWUCY]UDWXJS'
    'SW^@@KOCCBGGOBVLIKIBNWFXAQD\\SQ]ACU^@@BLSZ[LGIU[HDW\\]UDPAJ]HS'
    'GVVCRZ^@@VI\\ZMQYISGIJ[FY[JJCYUJAFDKLBB^@@FGRZACOJVNHPNXNCLQK'
    'VXKBONWLSD^@@YJKIQXIJMG\\[MVWMAPFVAGZBZDS\\M^@@VZMJ\\XFTVEWCUR['
    'ZUHSIWFCN\\NVWF^@@XWBBRUVOU\\RYSZQCGLMWYPZFGUDSV^@@VAUSRLBGNIF'
    '\\FPMKCFBXUYDKVWONN^@@ZUSOIZJQJOZXAXRCG[[HPZNZDHJ\\T^@@SWGZAXH'
    'DHYDZEKHHQH\\LOYSVIXG]R^@@YZHT\\C[LDIUGS\\VIS[IXEG\\ADXRIY^@@AIO'
    'WPARUIHHSV]D\\UUTKMNJTJ[AWI^@@PMGZNXF[QDYYNKRHQOTCZMZIZXWD[^@'
    '@AQXPIFTHHQV[PMUXK]EUEROKJ\\IAE^@@ZSGALXLIQOH\\HGFB]UHJZJOFQ]A'
    'HE^@@BJWPNEUVI]CNEYIJOEWRYGKFCKAYQ^@@G\\MGNKZFIJNGEYPZUICNQQR'
    'KWURXT^@@VWGIWBSRHRJKTXNJXUFF]RJCZGF]G^@@GFX[HYST\\QFWBJSHWU]'
    'SKCUANAUVJ^@@TTFMXFAQYGNLA\\ME]NBAQYTEOXVCJ^@@EQO]HNS\\PYJQDAL'
    'EVSRMNUQABPTPF^@@R[D[YMCQ\\LQ[TNHBNBMLPEYXJWCEC^@@N[V[XNRBPVH'
    'WOYTAPMFKAAESD]SEH^@@YOQRVMOLQKPCMY[MLSHOM\\EEVK[LO^@@TQTT[YO'
    'Q[YFVWSWOKPRPD\\TKT]MTK^@@WK]\\BEORM]KP[FLLLLOEDBERDKP\\B^@@BMR'
)
