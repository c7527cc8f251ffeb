"""seal_share_pct.embed (%): the pipeline's seal stage (the benchmark's
stage timer: SHA3-256, ECDH, HKDF, AES-256-GCM and the framing of the
payload into bits) over the embed jobs' time."""

from stegobench.readings import stage_share_pct


def read(rec):
    return stage_share_pct(rec, "seal")
