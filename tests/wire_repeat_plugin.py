"""A pytest plugin for tests/test_torch_kube_http_repeat.py: it repeats
test_each_client_speaks_to_each_server's port-to-port case REPEATS times
(ids r0..r29) and keeps the rest of tests/test_torch_kube_http.py as it is,
so an xdist run puts the repeats beside the file's other cases."""

from __future__ import annotations

REPEATS = 30
TARGET = "test_each_client_speaks_to_each_server"


def pytest_generate_tests(metafunc):
    if metafunc.function.__name__ == TARGET:
        metafunc.parametrize("wire", range(REPEATS), indirect=True, ids=lambda n: f"r{n}")


def pytest_collection_modifyitems(config, items):
    def keep(item):
        if item.originalname != TARGET:
            return True
        params = item.callspec.params
        return params["client_side"] == params["server_side"] == "port"

    dropped = [item for item in items if not keep(item)]
    config.hook.pytest_deselected(items=dropped)
    items[:] = [item for item in items if keep(item)]
