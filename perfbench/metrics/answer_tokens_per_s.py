"""Generated tokens of the answers asked and completed in the window,
over the time from the window's start to the last of them: an answer
still in progress at the close neither counts nor dilutes, and the loop
starts with none in progress.  Where the generator stalled before the
close (``RunData.stalled``), the time runs to the close."""


def read(run):
    last = run.t_end if run.stalled else run.t_last_done
    if last is None or last <= run.t0:
        return None
    tokens = sum(len(r.out.token_ids) for r in run.answers)
    return tokens / (last - run.t0) if tokens else None
