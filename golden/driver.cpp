// Golden-trajectory driver: runs the *actual* reference MOPS TBB (CPU)
// backend — compiled unmodified from /root/reference/src — on mesh and
// solution arrays supplied through a tagged binary file, and writes the
// resulting trajectories back in the same format.
//
// This closes the oracle loop demanded by SURVEY.md §4: mops_jax
// trajectories are compared against the reference's own compiled code
// (src/CPU/TBB/Kernel/MPASOVisualizerKernels.cpp), not against a hand
// transcription.
//
// Build (see mops_jax/oracle/refbin.py):
//   g++ -O2 -std=c++17 -I golden/shim -I $REF/src -I $REF/include \
//       -DMOPS_USE_CPU=1 -DMOPS_USE_TBB=1 -DMOPS_USE_GPU=0 \
//       -DMOPS_USE_SYCL=0 -DMOPS_USE_CUDA=0 -DMOPS_USE_HIP=0 \
//       -D_DEBUG=0 -DMOPS_VTK=0 \
//       golden/driver.cpp \
//       $REF/src/CPU/TBB/Kernel/MPASOVisualizerKernels.cpp \
//       $REF/src/CPU/TBB/Kernel/TBBKernel.cpp \
//       $REF/src/CPU/TBB/MPASOSolutionTBB.cpp \
//       -ltbb -o golden_driver
//
// Input tags (all little-endian; scalars are 1-element arrays):
//   i64: nCells nEdges maxEdges nVertices nVertLevels mode direction method
//        nan_cleanup velocity_scheme
//        (mode: 0=StreamLine 1=PathLine 2=VisualizeFixedLayer
//               3=VisualizeFixedDepth 4=VisualizeFixedLatitude
//               5=dump the derived fields the TBB preprocessing chain
//                 produced: cellVertexZTop, cellCenterVelocity,
//                 cellVertexVelocity, cellVertexVertVelocity, ctov:<name>)
//   viz modes only: i64 imageWidth imageHeight [nImages];
//        f64 latRange[2] lonRange[2] fixedLayer|fixedDepth|fixedLatitude
//   f64: deltaT duration recordT depth  (trajectory modes only)
//   f64: cellCoord[nCells*3] vertexCoord[nVertices*3]
//   i64: verticesOnCell[nCells*maxEdges] cellsOnCell[nCells*maxEdges]
//        numberVertexOnCell[nCells]              (connectivity 1-based, raw)
//   f64: cellZTop[nCells*L] cellVertVelocity[nCells*(L+1)]
//        zonal/meridional: cellZonalVelocity cellMeridionalVelocity [nCells*L]
//   f64: seeds[nSeeds*3] particleDepths[nSeeds] (optional)
//   i64: seedCells[nSeeds] (0-based; <0 triggers reference searchKDT path)
//   f64: attr:<name>[nCells*L]  (any number; map order = reference map order)
//   back-solution tags for pathline: back_cellZTop back_cellVertVelocity
//        back_cellZonalVelocity back_cellMeridionalVelocity back_attr:<name>
//
// Output tags:
//   i64: nLines nRecords
//   f64: points[nLines*nRecords*3] velocities[nLines*nRecords*3]
//        temperature[nLines*nRecords] salinity[nLines*nRecords]
//        lastPoint[nLines*3] depth[nLines]
//   i64: lineIDs[nLines]

#include "CPU/TBB/Kernel/MPASOVisualizerKernels.h"
#include "CPU/TBB/MPASOSolutionTBB.h"
#include "Common/TrajectoryCommon.h"
#include "Common/CommonUtils.h"

#include <cstdint>
#include <cstring>
#include <fstream>
#include <iostream>
#include <map>
#include <memory>
#include <string>
#include <vector>

// ---------------------------------------------------------------------------
// Definitions for the two MPASOGrid symbols the TBB kernels link against but
// whose home TU (src/Core/MPASOGrid.cpp) cannot be compiled here (it needs the
// external ftk ndarray library).  searchKDT reproduces nanoflann's exact-1-NN
// L2 semantics with a brute-force scan; it is only reached when the driver is
// given a negative seed cell id.
namespace MOPS {
MPASOGrid::MPASOGrid() = default;
void MPASOGrid::searchKDT(const CartesianCoord& point, int& cell_id)
{
    double best = std::numeric_limits<double>::infinity();
    int best_id = -1;
    for (size_t i = 0; i < cellCoord_vec.size(); ++i) {
        const double dx = cellCoord_vec[i].x - point.x;
        const double dy = cellCoord_vec[i].y - point.y;
        const double dz = cellCoord_vec[i].z - point.z;
        const double d = dx * dx + dy * dy + dz * dz;
        if (d < best) {
            best = d;
            best_id = static_cast<int>(i);
        }
    }
    cell_id = best_id;
}

// Connectivity getters used by MPASOField::isOnOcean (fixed-latitude path).
// Semantics match /root/reference/src/Core/MPASOGrid.cpp:315-361: slice the
// 1-based padded row for the id and subtract 1 from every entry.
static std::vector<size_t> SliceMinusOne(const std::vector<size_t>& table, size_t row, size_t width)
{
    std::vector<size_t> out(table.begin() + row * width, table.begin() + (row + 1) * width);
    for (auto& v : out) v -= 1;
    return out;
}
void MPASOGrid::getNeighborCells(const size_t cell_id, std::vector<size_t>& cell_on_cell, std::vector<size_t>& neighbor_id)
{
    neighbor_id = SliceMinusOne(cell_on_cell, cell_id, static_cast<size_t>(mMaxEdgesSize));
}
void MPASOGrid::getVerticesOnCell(const size_t cell_id, std::vector<size_t>& vertex_on_cell, std::vector<size_t>& vertex_id)
{
    vertex_id = SliceMinusOne(vertex_on_cell, cell_id, static_cast<size_t>(mMaxEdgesSize));
}
void MPASOGrid::getCellsOnVertex(const size_t vertex_id, std::vector<size_t>& cell_on_vertex, std::vector<size_t>& cell_id)
{
    cell_id = SliceMinusOne(cell_on_vertex, vertex_id, 3);
}
void MPASOGrid::getCellsOnEdge(const size_t edge_id, std::vector<size_t>& cell_on_edge, std::vector<size_t>& cell_id)
{
    cell_id = SliceMinusOne(cell_on_edge, edge_id, 2);
}
void MPASOGrid::getEdgesOnCell(const size_t cell_id, std::vector<size_t>& edge_on_cell, std::vector<size_t>& edge_id)
{
    edge_id = SliceMinusOne(edge_on_cell, cell_id, static_cast<size_t>(mMaxEdgesSize));
}
}  // namespace MOPS

namespace {

enum DType : int32_t { kF64 = 0, kI64 = 1 };

struct Blob {
    int32_t dtype = kF64;
    std::vector<char> raw;
    size_t count = 0;
};

using BlobMap = std::map<std::string, Blob>;

BlobMap ReadTagged(const std::string& path)
{
    std::ifstream f(path, std::ios::binary);
    if (!f) {
        std::cerr << "cannot open input " << path << "\n";
        std::exit(2);
    }
    char magic[8];
    f.read(magic, 8);
    if (std::memcmp(magic, "MOPSGLD1", 8) != 0) {
        std::cerr << "bad magic in " << path << "\n";
        std::exit(2);
    }
    int64_t n = 0;
    f.read(reinterpret_cast<char*>(&n), 8);
    BlobMap out;
    for (int64_t i = 0; i < n; ++i) {
        int32_t name_len = 0;
        f.read(reinterpret_cast<char*>(&name_len), 4);
        std::string name(static_cast<size_t>(name_len), '\0');
        f.read(name.data(), name_len);
        Blob b;
        f.read(reinterpret_cast<char*>(&b.dtype), 4);
        int64_t count = 0;
        f.read(reinterpret_cast<char*>(&count), 8);
        b.count = static_cast<size_t>(count);
        b.raw.resize(b.count * 8);
        f.read(b.raw.data(), static_cast<std::streamsize>(b.raw.size()));
        out.emplace(std::move(name), std::move(b));
    }
    if (!f) {
        std::cerr << "truncated input " << path << "\n";
        std::exit(2);
    }
    return out;
}

bool Has(const BlobMap& m, const std::string& k) { return m.count(k) != 0; }

std::vector<double> F64(const BlobMap& m, const std::string& k)
{
    auto it = m.find(k);
    if (it == m.end() || it->second.dtype != kF64) {
        std::cerr << "missing f64 tag " << k << "\n";
        std::exit(2);
    }
    std::vector<double> v(it->second.count);
    std::memcpy(v.data(), it->second.raw.data(), it->second.raw.size());
    return v;
}

std::vector<int64_t> I64(const BlobMap& m, const std::string& k)
{
    auto it = m.find(k);
    if (it == m.end() || it->second.dtype != kI64) {
        std::cerr << "missing i64 tag " << k << "\n";
        std::exit(2);
    }
    std::vector<int64_t> v(it->second.count);
    std::memcpy(v.data(), it->second.raw.data(), it->second.raw.size());
    return v;
}

int64_t ScalarI(const BlobMap& m, const std::string& k) { return I64(m, k).at(0); }
double ScalarF(const BlobMap& m, const std::string& k) { return F64(m, k).at(0); }

std::vector<vec3> ToVec3(const std::vector<double>& flat)
{
    std::vector<vec3> v(flat.size() / 3);
    for (size_t i = 0; i < v.size(); ++i) {
        v[i] = vec3(flat[3 * i], flat[3 * i + 1], flat[3 * i + 2]);
    }
    return v;
}

std::vector<size_t> ToSize(const std::vector<int64_t>& v)
{
    return std::vector<size_t>(v.begin(), v.end());
}

struct Writer {
    std::ofstream f;
    int64_t n = 0;
    std::streampos count_pos;

    explicit Writer(const std::string& path) : f(path, std::ios::binary)
    {
        f.write("MOPSGLD1", 8);
        count_pos = f.tellp();
        f.write(reinterpret_cast<char*>(&n), 8);
    }
    void Tag(const std::string& name, int32_t dtype, const void* data, size_t count)
    {
        int32_t name_len = static_cast<int32_t>(name.size());
        f.write(reinterpret_cast<char*>(&name_len), 4);
        f.write(name.data(), name_len);
        f.write(reinterpret_cast<char*>(&dtype), 4);
        int64_t c = static_cast<int64_t>(count);
        f.write(reinterpret_cast<char*>(&c), 8);
        f.write(reinterpret_cast<const char*>(data), static_cast<std::streamsize>(count * 8));
        ++n;
    }
    void F(const std::string& name, const std::vector<double>& v) { Tag(name, kF64, v.data(), v.size()); }
    void I(const std::string& name, const std::vector<int64_t>& v) { Tag(name, kI64, v.data(), v.size()); }
    void Close()
    {
        f.seekp(count_pos);
        f.write(reinterpret_cast<char*>(&n), 8);
        f.close();
    }
};

// Fill one MPASOSolution from raw cell-center fields and run the reference
// TBB preprocessing chain on it (mirrors MPASOSolution::calc* call sites in
// /root/reference/src/Core/MPASOSolution.cpp:720-960 minus the disk caches).
std::shared_ptr<MOPS::MPASOSolution> BuildSolution(
    const BlobMap& in, const std::string& prefix, MOPS::MPASOGrid* grid,
    const std::vector<size_t>& grid_info, int velocity_scheme)
{
    auto sol = std::make_shared<MOPS::MPASOSolution>();
    const int L = grid->mVertLevels;
    sol->mCellsSize = grid->mCellsSize;
    sol->mEdgesSize = grid->mEdgesSize;
    sol->mMaxEdgesSize = grid->mMaxEdgesSize;
    sol->mVertexSize = grid->mVertexSize;
    sol->mVertLevels = L;
    sol->mVertLevelsP1 = grid->mVertLevelsP1;
    sol->mTotalZTopLayer = L;
    sol->mTotalZTopLayerP1 = L + 1;

    sol->cellZTop_vec = F64(in, prefix + "cellZTop");
    sol->cellVertVelocity_vec = F64(in, prefix + "cellVertVelocity");

    // cellVertexZTop
    sol->cellVertexZTop_vec.assign(grid->vertexCoord_vec.size() * static_cast<size_t>(L), 0.0);
    MOPS::CPU::TBBBackend::CalcCellVertexZtop(
        grid, sol->mCellsSize, L, sol->cellZTop_vec, sol->cellVertexZTop_vec, grid_info);

    // cellCenterVelocity
    sol->cellCenterVelocity_vec.assign(static_cast<size_t>(grid->mCellsSize) * L, vec3(0, 0, 0));
    if (velocity_scheme == 1) {
        sol->cellNormalVelocity_vec = F64(in, prefix + "cellNormalVelocity");
        MOPS::CPU::TBBBackend::CalcCellCenterVelocity(
            grid, sol->mCellsSize, L, sol->cellNormalVelocity_vec,
            sol->cellCenterVelocity_vec, grid_info);
    } else {
        sol->cellZonalVelocity_vec = F64(in, prefix + "cellZonalVelocity");
        sol->cellMeridionalVelocity_vec = F64(in, prefix + "cellMeridionalVelocity");
        MOPS::CPU::TBBBackend::CalcCellCenterVelocityByZM(
            grid, sol->mCellsSize, L, sol->cellZonalVelocity_vec,
            sol->cellMeridionalVelocity_vec, sol->cellCenterVelocity_vec, grid_info);
    }

    // cellVertexVelocity
    sol->cellVertexVelocity_vec.assign(static_cast<size_t>(grid->mVertexSize) * L, vec3(0, 0, 0));
    MOPS::CPU::TBBBackend::CalcCellVertexVelocity(
        grid, sol->mCellsSize, L, sol->cellCenterVelocity_vec,
        sol->cellVertexVelocity_vec, grid_info);

    // cellVertexVertVelocity
    sol->cellVertexVertVelocity_vec.assign(
        static_cast<size_t>(grid->mVertexSize) * (L + 1), 0.0);
    MOPS::CPU::TBBBackend::CalcCellVertexVertVelocity(
        grid, sol->mCellsSize, L + 1, sol->cellVertVelocity_vec,
        sol->cellVertexVertVelocity_vec, grid_info);

    // attributes: tags "<prefix>attr:<name>" → mDoubleAttributes + CtoV
    const std::string attr_tag = prefix + "attr:";
    for (const auto& [key, blob] : in) {
        (void)blob;
        if (key.rfind(attr_tag, 0) != 0) continue;
        const std::string name = key.substr(attr_tag.size());
        std::vector<double> center = F64(in, key);
        std::vector<double> ctov(grid->vertexCoord_vec.size() * static_cast<size_t>(L), 0.0);
        MOPS::CPU::TBBBackend::CalcCellCenterToVertex(
            grid, sol->mCellsSize, L, center, ctov, grid_info);
        sol->mDoubleAttributes[name] = std::move(center);
        sol->mDoubleAttributes_CtoV[name] = std::move(ctov);
    }
    return sol;
}

}  // namespace

int main(int argc, char** argv)
{
    if (argc != 3) {
        std::cerr << "usage: golden_driver <input.bin> <output.bin>\n";
        return 2;
    }
    BlobMap in = ReadTagged(argv[1]);

    auto grid = std::make_shared<MOPS::MPASOGrid>();
    grid->mCellsSize = static_cast<int>(ScalarI(in, "nCells"));
    grid->mEdgesSize = static_cast<int>(ScalarI(in, "nEdges"));
    grid->mMaxEdgesSize = static_cast<int>(ScalarI(in, "maxEdges"));
    grid->mVertexSize = static_cast<int>(ScalarI(in, "nVertices"));
    grid->mVertLevels = static_cast<int>(ScalarI(in, "nVertLevels"));
    grid->mVertLevelsP1 = grid->mVertLevels + 1;
    grid->cellCoord_vec = ToVec3(F64(in, "cellCoord"));
    grid->vertexCoord_vec = ToVec3(F64(in, "vertexCoord"));
    grid->verticesOnCell_vec = ToSize(I64(in, "verticesOnCell"));
    grid->cellsOnCell_vec = ToSize(I64(in, "cellsOnCell"));
    grid->numberVertexOnCell_vec = ToSize(I64(in, "numberVertexOnCell"));
    if (Has(in, "cellsOnVertex")) grid->cellsOnVertex_vec = ToSize(I64(in, "cellsOnVertex"));
    if (Has(in, "edgesOnCell")) grid->edgesOnCell_vec = ToSize(I64(in, "edgesOnCell"));
    if (Has(in, "cellsOnEdge")) grid->cellsOnEdge_vec = ToSize(I64(in, "cellsOnEdge"));
    if (Has(in, "verticesOnEdge")) grid->verticesOnEdge_vec = ToSize(I64(in, "verticesOnEdge"));
    if (Has(in, "edgeCoord")) grid->edgeCoord_vec = ToVec3(F64(in, "edgeCoord"));
    if (Has(in, "cellRefBottomDepth")) grid->cellRefBottomDepth_vec = F64(in, "cellRefBottomDepth");

    std::vector<size_t> grid_info = MOPS::Common::BuildGridInfo(grid.get());
    const int velocity_scheme = Has(in, "velocity_scheme")
        ? static_cast<int>(ScalarI(in, "velocity_scheme")) : 0;

    auto field = std::make_shared<MOPS::MPASOField>();
    field->mGrid = grid;
    field->mSol_Front = BuildSolution(in, "", grid.get(), grid_info, velocity_scheme);

    const int mode = static_cast<int>(ScalarI(in, "mode"));
    if (mode == 1) {
        field->mSol_Back = BuildSolution(in, "back_", grid.get(), grid_info, velocity_scheme);
    }

    if (mode == 5) {
        // Dump the derived fields BuildSolution just computed with the
        // unmodified reference preprocessing kernels
        // (/root/reference/src/CPU/TBB/MPASOSolutionTBB.cpp).
        const auto& sol = *field->mSol_Front;
        Writer out(argv[2]);
        out.F("cellVertexZTop", sol.cellVertexZTop_vec);
        std::vector<double> ccv(sol.cellCenterVelocity_vec.size() * 3);
        for (size_t i = 0; i < sol.cellCenterVelocity_vec.size(); ++i) {
            ccv[3 * i + 0] = sol.cellCenterVelocity_vec[i].x();
            ccv[3 * i + 1] = sol.cellCenterVelocity_vec[i].y();
            ccv[3 * i + 2] = sol.cellCenterVelocity_vec[i].z();
        }
        out.F("cellCenterVelocity", ccv);
        std::vector<double> cvv(sol.cellVertexVelocity_vec.size() * 3);
        for (size_t i = 0; i < sol.cellVertexVelocity_vec.size(); ++i) {
            cvv[3 * i + 0] = sol.cellVertexVelocity_vec[i].x();
            cvv[3 * i + 1] = sol.cellVertexVelocity_vec[i].y();
            cvv[3 * i + 2] = sol.cellVertexVelocity_vec[i].z();
        }
        out.F("cellVertexVelocity", cvv);
        out.F("cellVertexVertVelocity", sol.cellVertexVertVelocity_vec);
        for (const auto& [name, vec] : sol.mDoubleAttributes_CtoV) {
            out.F("ctov:" + name, vec);
        }
        out.Close();
        return 0;
    }

    if (mode >= 2) {
        // Visualizer modes: run the reference TBB image kernels
        // (/root/reference/src/CPU/TBB/Kernel/MPASOVisualizerKernels.cpp:141-651)
        // and emit the raw RGBA-double pixel buffers.
        MOPS::VisualizationSettings vcfg;
        const int w = static_cast<int>(ScalarI(in, "imageWidth"));
        const int h = static_cast<int>(ScalarI(in, "imageHeight"));
        std::vector<double> latR = F64(in, "latRange");
        std::vector<double> lonR = F64(in, "lonRange");
        vcfg.imageSize = vec2{static_cast<double>(w), static_cast<double>(h)};
        vcfg.LatRange = vec2{latR.at(0), latR.at(1)};
        vcfg.LonRange = vec2{lonR.at(0), lonR.at(1)};

        std::vector<std::vector<double>> images;
        if (mode == 2) {
            vcfg.FixedLayer = ScalarF(in, "fixedLayer");
            MOPS::ImageBuffer<double> img(w, h);
            MOPS::CPU::TBBBackend::Kernel::VisualizeFixedLayer(field.get(), &vcfg, &img);
            images.push_back(img.mPixels);
        } else if (mode == 3) {
            vcfg.FixedDepth = ScalarF(in, "fixedDepth");
            const int n_img = Has(in, "nImages")
                ? static_cast<int>(ScalarI(in, "nImages")) : 1;
            std::vector<MOPS::ImageBuffer<double>> imgs;
            for (int k = 0; k < n_img; ++k) imgs.emplace_back(w, h);
            MOPS::CPU::TBBBackend::Kernel::VisualizeFixedDepth(field.get(), &vcfg, imgs);
            for (auto& im : imgs) images.push_back(im.mPixels);
        } else {
            vcfg.FixedLatitude = ScalarF(in, "fixedLatitude");
            MOPS::ImageBuffer<double> img(w, h);
            MOPS::CPU::TBBBackend::Kernel::VisualizeFixedLatitude(field.get(), &vcfg, &img);
            images.push_back(img.mPixels);
        }

        Writer out(argv[2]);
        std::vector<int64_t> wi{w}, hi{h}, ni{static_cast<int64_t>(images.size())};
        out.I("imageWidth", wi);
        out.I("imageHeight", hi);
        out.I("nImages", ni);
        for (size_t k = 0; k < images.size(); ++k) {
            out.F("image" + std::to_string(k), images[k]);
        }
        out.Close();
        return 0;
    }

    MOPS::TrajectorySettings cfg;
    cfg.deltaT = static_cast<size_t>(ScalarF(in, "deltaT"));
    cfg.simulationDuration = static_cast<size_t>(ScalarF(in, "duration"));
    cfg.recordT = static_cast<size_t>(ScalarF(in, "recordT"));
    cfg.depth = static_cast<float>(ScalarF(in, "depth"));
    cfg.directionType = static_cast<MOPS::CalcDirection>(ScalarI(in, "direction"));
    cfg.methodType = static_cast<MOPS::CalcMethodType>(ScalarI(in, "method"));
    if (Has(in, "particleDepths")) {
        std::vector<double> pd = F64(in, "particleDepths");
        cfg.particle_depths.assign(pd.begin(), pd.end());
    }

    std::vector<CartesianCoord> seeds = ToVec3(F64(in, "seeds"));
    std::vector<int> seed_cells;
    if (Has(in, "seedCells")) {
        for (int64_t c : I64(in, "seedCells")) seed_cells.push_back(static_cast<int>(c));
    }

    std::vector<MOPS::TrajectoryLine> lines;
    if (mode == 1) {
        lines = MOPS::CPU::TBBBackend::Kernel::PathLine(field.get(), seeds, &cfg, seed_cells);
    } else {
        lines = MOPS::CPU::TBBBackend::Kernel::StreamLine(field.get(), seeds, &cfg, seed_cells);
    }
    if (Has(in, "nan_cleanup") && ScalarI(in, "nan_cleanup") == 1) {
        lines = MOPS::Common::RemoveNaNTrajectoriesAndReindex(lines);
    }

    const size_t n_lines = lines.size();
    const size_t n_records = n_lines ? lines[0].points.size() : 0;
    std::vector<double> pts(n_lines * n_records * 3, 0.0);
    std::vector<double> vels(n_lines * n_records * 3, 0.0);
    std::vector<double> temp(n_lines * n_records, 0.0);
    std::vector<double> salt(n_lines * n_records, 0.0);
    std::vector<double> last(n_lines * 3, 0.0);
    std::vector<double> depths(n_lines, 0.0);
    std::vector<int64_t> ids(n_lines, 0);
    for (size_t i = 0; i < n_lines; ++i) {
        const auto& ln = lines[i];
        for (size_t j = 0; j < n_records && j < ln.points.size(); ++j) {
            pts[(i * n_records + j) * 3 + 0] = ln.points[j].x;
            pts[(i * n_records + j) * 3 + 1] = ln.points[j].y;
            pts[(i * n_records + j) * 3 + 2] = ln.points[j].z;
            if (j < ln.velocity.size()) {
                vels[(i * n_records + j) * 3 + 0] = ln.velocity[j].x;
                vels[(i * n_records + j) * 3 + 1] = ln.velocity[j].y;
                vels[(i * n_records + j) * 3 + 2] = ln.velocity[j].z;
            }
            if (j < ln.temperature.size()) temp[i * n_records + j] = ln.temperature[j];
            if (j < ln.salinity.size()) salt[i * n_records + j] = ln.salinity[j];
        }
        last[i * 3 + 0] = ln.lastPoint.x;
        last[i * 3 + 1] = ln.lastPoint.y;
        last[i * 3 + 2] = ln.lastPoint.z;
        depths[i] = ln.depth;
        ids[i] = ln.lineID;
    }

    Writer out(argv[2]);
    std::vector<int64_t> nl{static_cast<int64_t>(n_lines)};
    std::vector<int64_t> nr{static_cast<int64_t>(n_records)};
    out.I("nLines", nl);
    out.I("nRecords", nr);
    out.F("points", pts);
    out.F("velocities", vels);
    out.F("temperature", temp);
    out.F("salinity", salt);
    out.F("lastPoint", last);
    out.F("depth", depths);
    out.I("lineIDs", ids);
    out.Close();
    return 0;
}
