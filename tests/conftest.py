import os

# Unit tests run on the CPU backend with 8 virtual devices (the sharding
# tests need a multi-device mesh).  Where the environment also offers a GPU
# (JAX_PLATFORMS lists cuda), the CPU stays the default backend and the card
# stays reachable through jax.devices("gpu") for the tests marked `gpu`
# (the `gpu_device` fixture below skips them when there is no card).
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update(
    "jax_platforms",
    "cpu,cuda" if "cuda" in os.environ.get("JAX_PLATFORMS", "") else "cpu",
)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
REFERENCE_INPUT = "/root/reference/input"


class Golden:
    """Lazy dict-style access to a golden fixture npz."""

    def __init__(self, path):
        self.z = np.load(path)

    def __getitem__(self, k):
        return self.z[k]

    def __contains__(self, k):
        return k in self.z.files

    @property
    def dims(self):
        ne, nr, ns, nl, ny = self.z["dims"]
        return int(ne), int(nr), int(ns), int(nl), int(ny)


@pytest.fixture(scope="session")
def golden_ccw():
    return Golden(os.path.join(GOLDEN_DIR, "ccw.npz"))


@pytest.fixture(scope="session")
def golden_qhh():
    return Golden(os.path.join(GOLDEN_DIR, "qhh.npz"))


@pytest.fixture(scope="session")
def golden_heihe():
    return Golden(os.path.join(GOLDEN_DIR, "heihe.npz"))


def _load_mesh(project):
    from shud_tpu.core.device import to_device
    from shud_tpu.core.mesh import build_mesh
    from shud_tpu.io.project import load_project

    base = os.path.dirname(REFERENCE_INPUT)
    inp = load_project(project, base=base)
    md = build_mesh(inp)
    return inp, md, to_device(md)


@pytest.fixture(scope="session")
def ccw():
    return _load_mesh("ccw")


@pytest.fixture(scope="session")
def qhh():
    return _load_mesh("qhh")


@pytest.fixture(scope="session")
def heihe():
    return _load_mesh("heihe")


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU, or a skip when this process has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run on the card: python -m pytest -m gpu)")
