"""The peak of ``torch.cuda.max_memory_allocated()`` over the window
(reset at its start), in GiB."""


def read(run):
    if not run.peak_window:
        return None
    return run.peak_window / 2 ** 30
