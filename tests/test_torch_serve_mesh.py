"""The port's HTTP server on a mesh (``scripts/serve_http.py --tp``, the
request fan-out of ``inference/server.py``) against the same server on one
process: rank 0 serves HTTP and broadcasts each round's events (submits,
cancels, prefix registrations, stop) to the other ranks, which step their
engines in lockstep (``ServingDaemon.follow``).

TINY, fp32, random weights from a seed (``tools/dryrun_mesh.tiny_model``),
:class:`~unimedvl_tpu_torch.tools.dryrun_mesh.CharTokenizer`; the ranks are
spawned gloo processes (``parallel.mesh.run_on_ranks``). The answers are
strings, compared for equality.
"""

import numpy as np
import pytest

from unimedvl_tpu_torch.parallel import mesh as pmesh
from unimedvl_tpu_torch.tools import dryrun_mesh

RANKS_TIMEOUT_S = 240.0
ARGV = ["--slots", "4", "--capacity", "512", "--chunk", "4"]
PREFIX = "You are a radiology assistant. "


def _image(seed):
    return np.random.default_rng(seed).integers(0, 255, (24, 28, 3), dtype=np.uint8)


REQUESTS = [
    ("what is this?", _image(0), 6, False),
    ("describe the image", None, 8, False),
    ("any fracture?", _image(1), 5, False),
    ("short answer", None, 5, True),
    ("one word", None, 4, True),
    ("and now?", None, 7, False),
]


@pytest.fixture(scope="module")
def model():
    return dryrun_mesh.tiny_model(seed=3)


@pytest.fixture(scope="module")
def one_rank(model):
    return dryrun_mesh.http_rank(0, 1, model, ARGV, REQUESTS, PREFIX)


@pytest.mark.parametrize("tp,dp", [(2, 1), (1, 2)])
def test_server_on_a_mesh_answers_as_one_process(model, one_rank, tp, dp):
    """``serve_http --tp 2`` (and ``--dp 2``: slots over "data") over two
    gloo ranks: every request, a registered prefix among them, is answered
    through rank 0's HTTP routes with the one-process server's strings."""
    assert len(one_rank) == len(REQUESTS) and all(isinstance(a, str) for a in one_rank)
    assert not any("failed" in a or "rejected" in a for a in one_rank), one_rank
    got = pmesh.run_on_ranks(dryrun_mesh.http_rank, 2, model,
                             ARGV + ["--tp", str(tp), "--dp", str(dp)], REQUESTS, PREFIX,
                             timeout_s=RANKS_TIMEOUT_S)
    assert got[1] is None
    assert got[0] == one_rank
