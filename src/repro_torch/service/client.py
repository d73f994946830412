"""Blocking client for the plan server (stdlib sockets, one line per op).

``PlanClient`` speaks the newline-delimited JSON protocol of
:class:`~repro_torch.service.server.PlanServer`.  Requests sent through
:meth:`PlanClient.request_many` are pipelined on one connection with
``id`` correlation — the way to *provably* land N requests inside the
server's coalescing / batching window from a single client.
"""
from __future__ import annotations

import json
import socket
from typing import List, Optional

from ..core import PlanRequest
from .wire import encode_plan_request


class ServiceError(RuntimeError):
    """The server answered ``ok: false``; carries the structured error."""

    def __init__(self, error: dict):
        code = error.get("code", "unknown")
        super().__init__(f"[{code}] {error.get('message', '')}")
        self.code = code
        self.error = error


class PlanClient:
    """Client for one plan server.

    Args:
        host / port: server address.  ``port=None`` reads ``port_file``
            (the file ``PlanServer(port_file=...)`` writes on bind).
        timeout: socket timeout in seconds for each exchange.
    """

    def __init__(self, host: str = "127.0.0.1",
                 port: Optional[int] = None, *,
                 port_file=None, timeout: float = 120.0):
        if port is None:
            if port_file is None:
                raise ValueError("need a port or a port_file")
            with open(port_file) as f:
                port = int(f.read().strip())
        self.host, self.port, self.timeout = host, int(port), timeout

    # -- transport ----------------------------------------------------------

    def request_many(self, objs: List[dict]) -> List[dict]:
        """Send every request on ONE connection, pipelined; responses are
        correlated by ``id`` and returned in request order."""
        tagged = [{**o, "id": i} for i, o in enumerate(objs)]
        by_id: dict = {}
        with socket.create_connection((self.host, self.port),
                                      timeout=self.timeout) as s:
            f = s.makefile("rwb")
            for o in tagged:
                f.write((json.dumps(o) + "\n").encode())
            f.flush()
            for _ in tagged:
                line = f.readline()
                if not line:
                    raise ConnectionError(
                        "plan server closed the connection mid-exchange")
                resp = json.loads(line.decode())
                by_id[resp.get("id")] = resp
        missing = [i for i in range(len(tagged)) if i not in by_id]
        if missing:
            raise ConnectionError(
                f"no response for pipelined request(s) {missing}")
        return [by_id[i] for i in range(len(tagged))]

    def request(self, obj: dict) -> dict:
        return self.request_many([obj])[0]

    @staticmethod
    def _checked(resp: dict) -> dict:
        if not resp.get("ok"):
            raise ServiceError(resp.get("error", {}))
        return resp

    # -- ops ----------------------------------------------------------------

    def ping(self) -> bool:
        return bool(self._checked(self.request({"op": "ping"}))["ok"])

    def stats(self) -> dict:
        return self._checked(self.request({"op": "stats"}))["stats"]

    def cache_ls(self) -> List[dict]:
        return self._checked(self.request({"op": "cache_ls"}))["entries"]

    def cache_evict(self, fingerprint: str) -> bool:
        return self._checked(self.request(
            {"op": "cache_evict", "fingerprint": fingerprint}))["evicted"]

    def shutdown(self) -> None:
        self._checked(self.request({"op": "shutdown"}))

    def submit(self, req: PlanRequest, *, strategy: str = "pipette",
               day: int = 0) -> dict:
        """Plan a typed request; returns the full response
        (``resp["plan"]`` is the canonical plan JSON text,
        ``resp["meta"]["cache"]`` one of ``hit|miss|coalesced``).

        Raises:
            ServiceError: structured server rejection (``admission``,
                ``bad-request``, ``verifier``, ``internal``).
        """
        return self._checked(self.request(
            encode_plan_request(req, strategy=strategy, day=day)))

    def submit_many(self, reqs: List[PlanRequest], *,
                    strategy: str = "pipette", day: int = 0) -> List[dict]:
        """Pipeline several typed requests on one connection — all of
        them reach the server inside one batching window."""
        resps = self.request_many(
            [encode_plan_request(r, strategy=strategy, day=day)
             for r in reqs])
        return [self._checked(r) for r in resps]
