"""Fixtures that keep the port's test modules cheap in a whole run of the suite.

``tmp_path``: a whole CPU run of the tests writes gigabytes of checkpoints, run
directories and rank results under pytest's temp root, which keeps every
test's directory (and the last three runs' roots) after the run; on a small
disk the run then fails its later writes. A port test module that writes such
files imports ``tmp_path`` from here: pytest's own ``tmp_path``, removed at the
test's teardown when the test passed and kept, to be read, when it failed.
Its module-scoped directories (``tmp_path_factory.mktemp``) are removed at the
end of the module by their fixtures' teardown.

``one_thread``: one intra-op torch thread while a module runs. The suite runs
in parallel workers, each with a thread per core by default, and small CPU
kernels then slow down tenfold or more (on an 8-core host, one command-line
training test of ``test_torch_cli.py`` took 183 s beside five busy 8-thread
processes at the default count, and 18.5 s at one thread).
"""

import shutil

import pytest
import torch


@pytest.fixture
def tmp_path(tmp_path, request):
    """pytest's ``tmp_path``, removed after the test unless the test failed."""
    failed = request.session.testsfailed
    yield tmp_path
    if request.session.testsfailed == failed:
        shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while the importing module runs (autouse)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
