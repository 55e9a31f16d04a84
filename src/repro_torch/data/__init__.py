"""Data substrate of the port: the paper's stream generators and the
put-ahead pipeline (``pipeline.prefetch_to_device``, ``SyntheticCorpus``)."""

from .streams import (
    cauchy_stream,
    dynamic_cauchy_stream,
    tcp_like_group_streams,
    twitter_like_interval_streams,
)

__all__ = [
    "cauchy_stream",
    "dynamic_cauchy_stream",
    "tcp_like_group_streams",
    "twitter_like_interval_streams",
]
