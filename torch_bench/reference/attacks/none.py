"""No attack: every client sends its own row."""


def poison(rows, malicious, config):
    return rows
