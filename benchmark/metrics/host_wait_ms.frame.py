"""Host milliseconds per frame inside the program's ``row_upload`` spans:
the parameter row's blocking copy to the card, which waits for the stream
to drain (the host blocked on the device inside the program)."""

from benchmark import program


def read(ctx):
    got = program.recorded()
    if got is None:
        return None
    return 1e3 * program.seconds(got, "row_upload") / got.frames
