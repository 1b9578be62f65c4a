"""FEC codecs (ref: src-core/common/codings/)."""
