"""The discrete-event clock — the simulated half of the time seam.

Same three-method duck type as resilience.seam.Clock, plus an event
heap. The trick that lets the REAL protocol code run unmodified: its
poll loops all block via ``clock.sleep(...)``, so a simulated sleep is
where time advances — every event due inside the slept window fires (in
due order, ties broken by scheduling order) before the sleep returns.
A 1,000-host fleet's beats, arrivals and crashes are just events; the
observer's gate() polls exactly as it does on metal and sees the same
interleavings, at microseconds of real time per simulated second.

Wall vs monotonic: monotonic is THE timeline (starts at 0.0 and only
the event loop advances it); wall = monotonic + offset, and
``jump_wall`` moves the offset — an NTP step or suspend/resume in one
line, which is how the no-mass-expiry regression test steps the wall
clock backwards an hour mid-gate (the JAX package's tests/test_sim.py).
"""

import heapq


class SimClock:
    """Deterministic virtual time. Not thread-safe by design: the
    simulator is single-threaded (events ARE the concurrency)."""

    #: a recognizable fake epoch (mid-2023) so simulated wall stamps
    #: look like wall stamps in logs without ever touching time.time()
    START_WALL = 1.7e9

    def __init__(self, start_wall=START_WALL):
        self._mono = 0.0
        self._wall_offset = float(start_wall)
        self._heap = []          # (due_mono, seq, fn)
        self._seq = 0            # FIFO tie-break for same-instant events

    # -- the Clock duck type -----------------------------------------------
    def time(self):
        """Simulated wall seconds (subject to jump_wall steps)."""
        return self._mono + self._wall_offset

    def monotonic(self):
        return self._mono

    def sleep(self, seconds):
        """Advance virtual time by ``seconds``, firing every event due
        in the window. THE blocking primitive: the protocol code's poll
        loops make progress because the events they are waiting on
        (peer beats, round arrivals, crashes) fire inside their sleeps.
        """
        self.advance_to(self._mono + max(0.0, float(seconds)))

    # -- the event loop ------------------------------------------------------
    def at(self, due_mono, fn):
        """Schedule ``fn()`` at monotonic ``due_mono`` (clamped to now —
        the past is not available)."""
        heapq.heappush(self._heap,
                       (max(float(due_mono), self._mono), self._seq, fn))
        self._seq += 1

    def after(self, delay_s, fn):
        self.at(self._mono + max(0.0, float(delay_s)), fn)

    def advance_to(self, due_mono):
        """Run the event loop up to monotonic ``due_mono``. Events may
        schedule further events; anything that lands inside the window
        fires too (a recurring beat chains through it)."""
        due_mono = max(float(due_mono), self._mono)
        while self._heap and self._heap[0][0] <= due_mono:
            due, _, fn = heapq.heappop(self._heap)
            self._mono = max(self._mono, due)
            fn()
        self._mono = due_mono

    def pending(self):
        """Number of scheduled events not yet fired."""
        return len(self._heap)

    # -- fault injection on time itself --------------------------------------
    def jump_wall(self, delta_s):
        """Step the WALL clock by ``delta_s`` (negative = backwards —
        an NTP correction, a resumed laptop). Monotonic time is
        untouched, exactly like the real clocks; lease math on the
        monotonic source must not notice (the satellite-1 regression)."""
        self._wall_offset += float(delta_s)
