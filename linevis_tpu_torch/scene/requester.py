"""Async producers: file-loading and streamline-tracing requesters.

Counterpart of `linevis_tpu/scene/requester.py`, the reference's
worker-thread mailboxes:
* `LineDataRequester` (`src/LineData/LineDataRequester.hpp:40-56`): a
  mailbox of size ONE between the UI thread and a loader worker;
  `queue_request` replaces any pending request, `get_loaded_data` polls the
  reply slot; the worker loads one dataset at a time.
* `StreamlineTracingRequester` (`src/LineData/Flow/
  StreamlineTracingRequester.*`): the same mailbox driving the streamline
  tracer, which traces on the requester's `device` (the card unless the
  caller asks for the CPU) from the worker thread, on that thread's current
  CUDA stream.

The concurrency contract is the reference's (one worker, a single-slot
request box that newer requests overwrite, a single-slot reply box), which
the frame loop's `checkLoadingRequestFinished` polling
(`MainApp.cpp:2432-2499`) is built around. A failure in the worker is
handed back through the reply slot and raised at the poll.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

__all__ = ["LineDataRequester", "StreamlineTracingRequester"]


class _MailboxWorker:
    """Size-1 request/reply mailbox + daemon worker thread."""

    def __init__(self, process: Callable[[Any], Any]):
        self._process = process
        self._cond = threading.Condition()
        self._request: Optional[Any] = None
        self._reply: Optional[Any] = None
        self._busy = False
        self._shutdown = False
        self._thread = threading.Thread(target=self._main, daemon=True)
        self._thread.start()

    def queue_request(self, request: Any) -> None:
        """Replace any pending request (LineDataRequester.hpp:44-46:
        a newer request supersedes an unstarted older one)."""
        with self._cond:
            self._request = request
            self._cond.notify()

    def get_reply(self) -> Optional[Any]:
        """Poll the reply slot; returns None while loading."""
        with self._cond:
            reply = self._reply
            self._reply = None
            return reply

    @property
    def is_processing(self) -> bool:
        with self._cond:
            return self._busy or self._request is not None

    def join(self, timeout: float = 10.0) -> None:
        """Block until the current request (if any) completes."""
        import time

        end = time.time() + timeout
        while time.time() < end:
            with self._cond:
                if not self._busy and self._request is None:
                    return
            time.sleep(0.005)

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify()

    def _main(self) -> None:
        while True:
            with self._cond:
                while self._request is None and not self._shutdown:
                    self._cond.wait()
                if self._shutdown:
                    return
                request = self._request
                self._request = None
                self._busy = True
            try:
                reply = self._process(request)
            except Exception as exc:  # surface errors through the mailbox
                reply = exc
            with self._cond:
                self._reply = reply
                self._busy = False


class LineDataRequester:
    """Async dataset loading (LineDataRequester.hpp:40-56).

    queue_request(filenames, **kwargs) hands a load to the worker;
    get_loaded_data() polls — returns the loaded LineData object once,
    then None again.  Exceptions raised by the loader are re-raised at
    the poll site (the reference shows a dialog from the main thread).
    """

    def __init__(self):
        def process(req):
            from linevis_tpu_torch.scene.factory import load_line_data

            info, kwargs = req
            if isinstance(info, (list, tuple)):
                info = info[0]  # factory dispatch keys off the first file
            return load_line_data(info, **kwargs)

        self._worker = _MailboxWorker(process)

    def queue_request(self, filenames, **kwargs) -> None:
        self._worker.queue_request((filenames, kwargs))

    def get_loaded_data(self):
        reply = self._worker.get_reply()
        if isinstance(reply, Exception):
            raise reply
        return reply

    @property
    def is_processing(self) -> bool:
        return self._worker.is_processing

    def join(self, timeout: float = 30.0) -> None:
        self._worker.join(timeout)


class StreamlineTracingRequester:
    """Async streamline tracing (StreamlineTracingRequester.*): a trace
    request carries (velocity_fn, StreamlineTracingSettings); the reply is
    the Trajectories traced on `device`."""

    def __init__(self, device="cuda"):
        self.device = device

        def process(req):
            from linevis_tpu_torch.trace.streamline import trace_streamlines

            velocity, settings = req
            return trace_streamlines(velocity, settings, device=self.device)

        self._worker = _MailboxWorker(process)

    def queue_request(self, velocity, settings) -> None:
        self._worker.queue_request((velocity, settings))

    def get_traced_lines(self):
        reply = self._worker.get_reply()
        if isinstance(reply, Exception):
            raise reply
        return reply

    @property
    def is_processing(self) -> bool:
        return self._worker.is_processing

    def join(self, timeout: float = 60.0) -> None:
        self._worker.join(timeout)
