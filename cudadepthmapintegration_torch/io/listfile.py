"""List-file resolution (vtiList.txt / kList.txt).

Mirrors ``help::ExtractAllFilePath`` (``Sources/Helper.h:60-100``): each
non-empty line's LAST whitespace-separated token is taken as a file name and
resolved relative to the directory containing the list file itself (or the
current working directory if the list path has no directory part).
"""

from __future__ import annotations

import os

__all__ = ["extract_all_file_paths"]


def extract_all_file_paths(list_path: str | os.PathLike) -> list[str]:
    list_path = os.fspath(list_path)
    directory = os.path.dirname(list_path.replace("\\", "/"))
    if directory == "":
        directory = os.getcwd()
    paths: list[str] = []
    with open(list_path, "r") as f:
        for line in f:
            tokens = line.split()
            if not tokens:
                continue
            paths.append(os.path.join(directory, tokens[-1]))
    return paths
