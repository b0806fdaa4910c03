"""The input pipeline's wait: the mean ``step_wait_ms`` of the program's
``PipelineStats`` over the window's steps (how long each step waited on
``data/prefetch.HostPrefetcher`` for its batch)."""


def read(lc):
    return lc.get("step_wait_ms")
