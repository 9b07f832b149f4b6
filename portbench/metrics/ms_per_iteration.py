"""Window ms over the iterations the program reported (every lane's k):
everything charged to a registration, index build and chunk tail
included."""


def read(window):
    return window.seconds * 1e3 / sum(window.ks)
