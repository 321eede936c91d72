"""blur_rows_roofline (%, device trace): B1 (``blur_rows_kernel``), the
least time of the passes of the blur tasks whose result reached the client
inside the window (``roofline.blur.pass_work`` over each frame's buffer,
each pass's bound), over B1's device time inside the window."""
from perfbench.harness.readers import done_in_window, kernel_seconds, share
from perfbench.harness.traffic import BLUR_KERNELS, buffer_px
from perfbench.roofline import blur, peaks


def read(run):
    bound = 0.0
    for r in done_in_window(run):
        b = buffer_px(r.req.px)
        one = peaks.bound_s(*blur.pass_work(b, b, BLUR_KERNELS[r.req.kernel]),
                            run.device_kind)
        if one is None:
            return None
        bound += r.req.iters * one
    return share(bound, kernel_seconds(run, "blur_rows_kernel"))
