"""Native (C++) host components: entropy decode + segment scanning.

Built on demand with g++ (build.py) and bound over the C ABI via ctypes
— the TPU build's equivalent of the reference's C++ host core
(SURVEY.md §2 native-component rule)."""
