"""``python -m repro.service`` entry points.

``python -m repro.service serve ...``  -> the HTTP transport front end
                                          (``transport.serve_main``).
``python -m repro.service <runner args>`` -> the resumable sweep runner
                                          CLI (backward compatible).
"""
import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        from .transport import serve_main
        return serve_main(argv[1:])
    from .runner import main as runner_main
    return runner_main(argv)


if __name__ == "__main__":
    main()
