"""The rendezvous KV of the port: its HTTP client (``http_client``: endpoint
sets with failover and a circuit breaker, long-poll reads, retried writes,
the chunked large-value transfer checkpoint shards ride) and its server
(``http_server.KVStoreServer``). The launcher (``tpurun``, ``run()``, the
``RendezvousServer``), replication and the slice aggregator come with
ROADMAP A14."""

from .http_client import (Endpoints, KVBackpressure,  # noqa: F401
                          delete_data_from_kvstore, delete_large_value,
                          put_data_into_kvstore, put_large_value,
                          read_data_from_kvstore, read_large_value,
                          resolve_endpoints)
from .http_server import KVStoreServer  # noqa: F401
