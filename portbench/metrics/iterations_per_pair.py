"""Mean k over every registration of the window, as the program reports
it: fewer iterations against faster ones."""


def read(window):
    ks = window.ks
    return sum(ks) / len(ks)
