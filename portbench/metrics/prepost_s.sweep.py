"""Seconds an edit in the lockstep batch and edit API: preprocess (transform
fields, mask sets, text and VAE encode) and decode and post-processing."""

from portbench.metrics import layers


def read(rec):
    return layers.per_unit(rec, "preprocess", "decode_post")
